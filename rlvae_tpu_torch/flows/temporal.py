"""Temporal flow chain: one IAF per timestep transition.

Port of ``rlvae_tpu/flows/temporal.py:30-173``.  Given z_0 and n_obs, flow
t-1 maps z_{t-1} -> z_t, accumulating each transition's log|det J|; past
the last flow, the last flow is reused.

- ``density`` direction: all n_obs-1 transitions run as one IAF-chain
  launch, and their gradient as one backward launch, through the autograd
  Function :class:`~rlvae_tpu_torch.ops.iaf_kernels.IAFChain`; autograd
  through the weight stacking applies the masks and sums the gradients of
  the reused flow (:mod:`rlvae_tpu_torch.ops.iaf_kernels`).
- ``sampling`` direction: one :func:`~rlvae_tpu_torch.flows.iaf.iaf_inverse`
  per transition in a plain loop (one parallel MADE pass per block), as
  the JAX package runs it; it launches no kernel, and autograd
  differentiates it.

The Jacobi fixed-point blocks (``fixedpoint_iters > 0``) are not ported yet
and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rlvae_tpu_torch.flows.iaf import IAF, iaf_inverse
from rlvae_tpu_torch.ops.iaf_kernels import IAFChain, stack_chain


class TemporalFlows(nn.Module):
    """``n_flows`` IAFs plus the static chain configuration."""

    def __init__(self, latent_dim: int, n_flows: int = 8, hidden_size: int = 256,
                 n_blocks: int = 2, n_hidden: int = 3, direction: str = "density",
                 log_var_bias_init: float = -2.0, fixedpoint_iters: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if direction not in ("density", "sampling"):
            raise ValueError("direction must be 'density' or 'sampling'")
        if fixedpoint_iters < 0:
            raise ValueError("fixedpoint_iters must be >= 0")
        if fixedpoint_iters > 0:
            raise NotImplementedError("flow_fixedpoint_iters > 0 (Jacobi blocks) is not ported yet")
        self.latent_dim = latent_dim
        self.n_flows = n_flows
        self.hidden_size = hidden_size
        self.n_blocks = n_blocks
        self.n_hidden = n_hidden
        self.direction = direction
        self.fixedpoint_iters = fixedpoint_iters
        self.flows = nn.ModuleList(
            IAF(latent_dim, hidden_size, n_blocks, n_hidden, generator, log_var_bias_init)
            for _ in range(n_flows)
        )


def apply_temporal_flows(
    flows: TemporalFlows, z0: torch.Tensor, n_obs: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evolve z0 through time.

    Returns z_seq [B, n_obs, D] (z_seq[:, 0] == z0) and log_dets [B, n_obs-1].
    """
    nt = n_obs - 1
    if nt < 1 or flows.n_flows == 0:
        z_seq = z0[:, None, :].expand(-1, n_obs, -1).contiguous()
        return z_seq, z0.new_zeros((z0.shape[0], 0))
    chain = [flows.flows[min(t, flows.n_flows - 1)] for t in range(nt)]
    if flows.direction == "sampling":
        zs, lds = [z0], []
        for iaf in chain:
            z_t, ld = iaf_inverse(iaf, zs[-1])
            zs.append(z_t)
            lds.append(ld)
        return torch.stack(zs, dim=1), torch.stack(lds, dim=1)
    z_rest, lds = IAFChain.apply(z0.float().contiguous(), *stack_chain(chain))
    z_seq = torch.cat([z0[:, None, :].float(), z_rest.transpose(0, 1)], dim=1)
    return z_seq, lds.transpose(0, 1)
