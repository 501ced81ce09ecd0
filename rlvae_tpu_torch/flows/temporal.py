"""Temporal flow chain: one IAF per timestep transition.

Port of ``rlvae_tpu/flows/temporal.py:30-173``.  Given z_0 and n_obs, flow
t-1 maps z_{t-1} -> z_t, accumulating each transition's log|det J|; past
the last flow, the last flow is reused.

- ``density`` direction: all n_obs-1 transitions run as one IAF-chain
  launch, and their gradient as one backward launch, through the autograd
  Function :class:`~rlvae_tpu_torch.ops.iaf_kernels.IAFChain`; autograd
  through the weight stacking applies the masks and sums the gradients of
  the reused flow (:mod:`rlvae_tpu_torch.ops.iaf_kernels`).
  ``fixedpoint_iters = K > 0`` runs each MADE block of the chain as K
  Jacobi passes and a final one (exact at K >= D - 1), and the backward
  at K + 1 adjoint sweeps: the JAX package's kernel pair with ``fp_iters =
  K`` (its CPU path differentiates through the iterations instead).
- past the chain kernels' envelope (D > 32 or H > 256,
  :func:`~rlvae_tpu_torch.ops.iaf_kernels.chain_supported`) the density
  transitions run one :func:`~rlvae_tpu_torch.flows.iaf.iaf_forward` (or
  ``iaf_forward_fixedpoint``) each in a plain loop, as JAX's ``_use_fused``
  takes XLA there, counted in ``plain_route.calls`` on the card; a hidden
  width that is not a multiple of 4 reaches the kernels padded with
  zero-weight units (:func:`~rlvae_tpu_torch.ops.iaf_kernels.pad_hidden`).
- ``sampling`` direction: one :func:`~rlvae_tpu_torch.flows.iaf.iaf_inverse`
  per transition in a plain loop (one parallel MADE pass per block), as
  the JAX package runs it; it launches no kernel, and autograd
  differentiates it.  ``fixedpoint_iters`` does not apply to it and is
  ignored, as in JAX (``rlvae_tpu/flows/temporal.py:155-161``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rlvae_tpu_torch.flows.iaf import IAF, iaf_forward, iaf_forward_fixedpoint, iaf_inverse
# the module, not its names: ops.iaf_kernels imports flows.made, so either
# package may be the first one imported
from rlvae_tpu_torch.ops import iaf_kernels as _iaf
from rlvae_tpu_torch.ops._launch import plain_route


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
        self.latent_dim = latent_dim
        self.n_flows = n_flows
        self.hidden_size = hidden_size
        self.n_blocks = n_blocks
        self.n_hidden = n_hidden
        self.direction = direction
        self.fixedpoint_iters = int(fixedpoint_iters)
        self.flows = nn.ModuleList(
            IAF(latent_dim, hidden_size, n_blocks, n_hidden, generator, log_var_bias_init)
            for _ in range(n_flows)
        )


def _per_transition(chain, step, z0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """z_seq [B, NT + 1, D] and log_dets [B, NT] of ``step(iaf, z)`` per
    transition, in a plain loop."""
    zs, lds = [z0], []
    for iaf in chain:
        z_t, ld = step(iaf, zs[-1])
        zs.append(z_t)
        lds.append(ld)
    return torch.stack(zs, dim=1), torch.stack(lds, dim=1)


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
        return _per_transition(chain, iaf_inverse, z0)
    if not _iaf.chain_supported(flows.latent_dim, flows.hidden_size):
        # past the chain kernels' envelope: JAX's XLA transitions
        k = flows.fixedpoint_iters
        step = iaf_forward if k == 0 else (lambda iaf, z: iaf_forward_fixedpoint(iaf, z, k))
        return plain_route(lambda z: _per_transition(chain, step, z), z0)
    stack = _iaf.stack_chain(chain)
    if z0.device.type == "cuda":
        stack = _iaf.pad_hidden(stack)  # H % 4 != 0: zero-weight units, exact
    z_rest, lds = _iaf.IAFChain.apply(z0.float().contiguous(), *stack, flows.fixedpoint_iters)
    z_seq = torch.cat([z0[:, None, :].float(), z_rest.transpose(0, 1)], dim=1)
    return z_seq, lds.transpose(0, 1)
