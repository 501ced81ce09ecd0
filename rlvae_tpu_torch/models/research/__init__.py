"""Research models on the port's paths: ``LVAE_IAF``, ``LVAE_GUGUS`` (every
variant) and ``RIEM``, ports of ``rlvae_tpu/models/research/`` (the
others, ``LLDM``, ``VAMP`` and ``GPVAE``, are not ported yet)."""

from rlvae_tpu_torch.models.research._sampled import SampledMetric
from rlvae_tpu_torch.models.research.gugus import LVAE_GUGUS
from rlvae_tpu_torch.models.research.lvae_iaf import LVAE_IAF
from rlvae_tpu_torch.models.research.riem import RIEM

__all__ = ["LVAE_GUGUS", "LVAE_IAF", "RIEM", "SampledMetric"]
