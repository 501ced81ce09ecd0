"""Masked autoregressive flows: MADE, IAF and the temporal chain."""

from rlvae_tpu_torch.flows.iaf import IAF, iaf_forward, iaf_inverse
from rlvae_tpu_torch.flows.made import MADE, make_masks
from rlvae_tpu_torch.flows.temporal import TemporalFlows, apply_temporal_flows

__all__ = ["IAF", "MADE", "TemporalFlows", "apply_temporal_flows", "iaf_forward", "iaf_inverse",
           "make_masks"]
