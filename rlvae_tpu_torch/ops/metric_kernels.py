"""The chol-bundle: (chol(G^{-1}(z)), logdet G^{-1}(z)) in one launch.

Port of ``chol_bundle_pallas`` (``rlvae_tpu/ops/metric_kernels.py:470``) as
the hand-written CUDA kernel ``csrc/chol_bundle.cu``.  For each row of z:

    w_k    = exp(-||z - c_k||^2 * inv_t2)          (direct differences, fp32)
    G^{-1} = sum_k w_k M_k + diag * I              (diag = lbd + jitter)
    L      = chol(G^{-1}),  logdet = 2 sum_i log L_ii

:func:`chol_bundle` launches the kernel for CUDA tensors and runs
:func:`chol_bundle_ref`, the plain PyTorch version, for CPU tensors; there
is no other route.  ``chol_bundle.launches`` counts kernel launches.

:class:`CholBundle` makes the bundle's factor L differentiable in ``z``, as
``chol_g_inv_fused`` does on the JAX side (``metric_kernels.py:759-784``):
the forward is :func:`chol_bundle`; the backward re-evaluates
:func:`chol_bundle_ref` under autograd and returns its VJP (the JAX package
recomputes through its XLA path with ``jax.vjp``, not a kernel).  The
metric's centroids and matrices are buffers and get no gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rlvae_tpu_torch.ops import linalg as _lin
from rlvae_tpu_torch.ops._launch import check_inputs, raise_on_error, stream_handle

KERNEL_DIM = 16  # the kernel's latent dim (csrc/chol_bundle.cu: D)


def chol_bundle_ref(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
    inv_t2: float, diag: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: L [B, D, D] lower-triangular and logdet [B]."""
    k, d = centroids.shape
    diff = z.float()[:, None, :] - centroids[None, :, :]  # [B, K, D]
    w = torch.exp(-(diff * diff).sum(-1) * inv_t2)
    gi = (w @ matrices.reshape(k, d * d)).reshape(-1, d, d)
    gi = gi + diag * torch.eye(d, dtype=gi.dtype, device=gi.device)
    l = _lin.cholesky_small(gi)
    return l, _lin.logdet_from_chol(l)


def chol_bundle(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
    inv_t2: float, diag: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, logdet) of G^{-1}(z) + (diag - lbd) I; kernel on CUDA, plain on CPU."""
    if z.device.type == "cpu":
        return chol_bundle_ref(z, centroids, matrices, inv_t2, diag)
    if z.device.type != "cuda":
        raise ValueError(f"chol_bundle: unsupported device {z.device}")
    check_inputs("chol_bundle", z.device, z=z, centroids=centroids, matrices=matrices)
    b, d = z.shape
    k = centroids.shape[0]
    if d != KERNEL_DIM or centroids.shape != (k, d) or matrices.shape != (k, d, d):
        raise ValueError(
            f"chol_bundle: kernel takes z [B,{KERNEL_DIM}], c [K,{KERNEL_DIM}], "
            f"M [K,{KERNEL_DIM},{KERNEL_DIM}]; got {tuple(z.shape)}, "
            f"{tuple(centroids.shape)}, {tuple(matrices.shape)}"
        )
    if k < 1:
        raise ValueError("chol_bundle: empty centroid bank")
    l = torch.empty((b, d, d), dtype=torch.float32, device=z.device)
    logdet = torch.empty((b,), dtype=torch.float32, device=z.device)
    if b == 0:
        return l, logdet
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().chol_bundle_f32(
        z.data_ptr(), centroids.data_ptr(), matrices.data_ptr(),
        float(inv_t2), float(diag), l.data_ptr(), logdet.data_ptr(),
        b, k, stream_handle(z.device),
    )
    raise_on_error("chol_bundle", code)
    chol_bundle.launches += 1
    return l, logdet


chol_bundle.launches = 0


class CholBundle(torch.autograd.Function):
    """L = chol_bundle(z, ...)[0], differentiable in ``z``."""

    @staticmethod
    def forward(ctx, z, centroids, matrices, inv_t2: float, diag: float):
        ctx.save_for_backward(z, centroids, matrices)
        ctx.inv_t2, ctx.diag = inv_t2, diag
        return chol_bundle(z.detach(), centroids, matrices, inv_t2, diag)[0]

    @staticmethod
    def backward(ctx, dl):
        z, centroids, matrices = ctx.saved_tensors
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            l, _ = chol_bundle_ref(zz, centroids, matrices, ctx.inv_t2, ctx.diag)
            (dz,) = torch.autograd.grad(l, zz, dl)
        return dz, None, None, None, None
