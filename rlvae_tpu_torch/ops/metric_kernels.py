"""The metric kernels: the chol-bundle and the HMC terms.

**chol-bundle**: (chol(G^{-1}(z)), logdet G^{-1}(z)) in one launch.  Port of
``chol_bundle_pallas`` (``rlvae_tpu/ops/metric_kernels.py:470``) as the
hand-written CUDA kernel ``csrc/chol_bundle.cu``.  For each row of z:

    w_k    = exp(-||z - c_k||^2 * inv_t2)          (direct differences, fp32)
    G^{-1} = sum_k w_k M_k + diag * I              (diag = lbd + jitter)
    L      = chol(G^{-1}),  logdet = 2 sum_i log L_ii

**HMC terms**: (log pi, pythae-form grad log pi) in one launch.  Port of
``hmc_terms_pallas`` (``rlvae_tpu/ops/metric_kernels.py:809``) as
``csrc/hmc_terms.cu``.  With G^{-1} and L as above (diag = lbd):

    log pi = logaddexp(sum_i log L_ii, log_eps)
    v_j    = -2 inv_t2 sum_k w_k sum_i (c_k - z)_i M_k[i, j]   (weighted differences)
    grad   = -1/2 G v,  G = (G^{-1})^{-1}

This is the gradient the reference's sampler integrates with, not the exact
gradient of log pi (``rlvae_tpu/geometry/metric.py:228-263``).

:func:`chol_bundle` and :func:`hmc_terms` launch their kernels for CUDA
tensors and run the plain PyTorch versions (:func:`chol_bundle_ref`,
:func:`hmc_terms_ref`) for CPU tensors; there is no other route.  Each
wrapper's ``launches`` counts its kernel launches.

:class:`CholBundle` and :class:`CholBundleLogdet` make the bundle's factor L
and its logdet differentiable in ``z``, as ``chol_g_inv_fused`` does on the
JAX side (``metric_kernels.py:759-784``): the forward is one
:func:`chol_bundle` launch; the backward re-evaluates :func:`chol_bundle_ref`
under autograd and returns its VJP (the JAX package recomputes through its
XLA path with ``jax.vjp``, not a kernel).  The metric's centroids and
matrices are buffers and get no gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rlvae_tpu_torch.ops import linalg as _lin
from rlvae_tpu_torch.ops._launch import check_inputs, raise_on_error, stream_handle

KERNEL_DIM = 16  # the kernels' latent dim (csrc/chol_bundle.cu, csrc/hmc_terms.cu: D)


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


def _check_bank_shapes(name: str, z, centroids, matrices) -> Tuple[int, int]:
    """(B, K) of z [B, 16], c [K, 16], M [K, 16, 16]; raise on anything else."""
    d = KERNEL_DIM
    b, k = z.shape[0], centroids.shape[0]
    if z.shape != (b, d) or centroids.shape != (k, d) or matrices.shape != (k, d, d):
        raise ValueError(
            f"{name}: kernel takes z [B,{d}], c [K,{d}], M [K,{d},{d}]; got "
            f"{tuple(z.shape)}, {tuple(centroids.shape)}, {tuple(matrices.shape)}"
        )
    if k < 1:
        raise ValueError(f"{name}: empty centroid bank")
    return b, k


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
    b, k = _check_bank_shapes("chol_bundle", z, centroids, matrices)
    d = KERNEL_DIM
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


def _recompute_vjp(ctx, output: int, cotangent):
    """VJP in z of output ``output`` (0: L, 1: logdet) of the bundle,
    re-evaluated through its plain version under autograd."""
    z, centroids, matrices = ctx.saved_tensors
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        out = chol_bundle_ref(zz, centroids, matrices, ctx.inv_t2, ctx.diag)[output]
        (dz,) = torch.autograd.grad(out, zz, cotangent)
    return dz, None, None, None, None


class CholBundle(torch.autograd.Function):
    """L = chol_bundle(z, ...)[0], differentiable in ``z``."""

    @staticmethod
    def forward(ctx, z, centroids, matrices, inv_t2: float, diag: float):
        ctx.save_for_backward(z, centroids, matrices)
        ctx.inv_t2, ctx.diag = inv_t2, diag
        return chol_bundle(z.detach(), centroids, matrices, inv_t2, diag)[0]

    @staticmethod
    def backward(ctx, dl):
        return _recompute_vjp(ctx, 0, dl)


class CholBundleLogdet(torch.autograd.Function):
    """logdet = chol_bundle(z, ...)[1], differentiable in ``z``."""

    @staticmethod
    def forward(ctx, z, centroids, matrices, inv_t2: float, diag: float):
        ctx.save_for_backward(z, centroids, matrices)
        ctx.inv_t2, ctx.diag = inv_t2, diag
        return chol_bundle(z.detach(), centroids, matrices, inv_t2, diag)[1]

    @staticmethod
    def backward(ctx, dld):
        return _recompute_vjp(ctx, 1, dld)


# ---------------------------------------------------------------------------
# HMC terms
# ---------------------------------------------------------------------------


def hmc_terms_ref(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
    inv_t2: float, lbd: float, log_eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: log pi [B] and the pythae-form grad [B, D].

    The same arithmetic as the JAX package's XLA terms
    (``gm.log_sqrt_det_g_inv`` and ``gm.grad_log_sqrt_det_g_inv``): G formed
    by an explicit inverse of G^{-1} (``inv_psd_small``'s solves, on the one
    factor L that the logdet also reads), and grad = -1/2 G^T v."""
    k, d = centroids.shape
    z = z.to(centroids.dtype)  # fp32; fp64 banks give the fp64 evaluation
    diff = z[:, None, :] - centroids[None, :, :]  # [B, K, D]
    w = torch.exp(-(diff * diff).sum(-1) * inv_t2)  # [B, K]
    eye = torch.eye(d, dtype=z.dtype, device=z.device)
    gi = (w @ matrices.reshape(k, d * d)).reshape(-1, d, d) + lbd * eye
    l = _lin.cholesky_small(gi)
    half_ld = 0.5 * _lin.logdet_from_chol(l)
    log_pi = torch.logaddexp(half_ld, half_ld.new_tensor(log_eps))
    # v[b, j] = sum_k w[b, k] sum_i (c - z)[b, k, i] M[k, i, j]: the weighted
    # differences contracted with M, never sum(w c M) - sum(w z M)
    wd = w[:, :, None] * (centroids[None, :, :] - z[:, None, :])  # [B, K, D]
    v = (-2.0 * inv_t2) * (wd.reshape(-1, k * d) @ matrices.reshape(k * d, d))
    g = _lin.tri_solve_upper_t(l, _lin.tri_solve_lower(l, eye.expand(gi.shape)))
    grad = -0.5 * torch.einsum("bji,bj->bi", g, v)
    return log_pi, grad


def hmc_terms(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
    inv_t2: float, lbd: float, log_eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log pi [B], grad [B, D]) of the HMC target; kernel on CUDA, plain on CPU."""
    if z.device.type == "cpu":
        return hmc_terms_ref(z, centroids, matrices, inv_t2, lbd, log_eps)
    if z.device.type != "cuda":
        raise ValueError(f"hmc_terms: unsupported device {z.device}")
    check_inputs("hmc_terms", z.device, z=z, centroids=centroids, matrices=matrices)
    b, k = _check_bank_shapes("hmc_terms", z, centroids, matrices)
    log_pi = torch.empty((b,), dtype=torch.float32, device=z.device)
    grad = torch.empty((b, KERNEL_DIM), dtype=torch.float32, device=z.device)
    if b == 0:
        return log_pi, grad
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().hmc_terms_f32(
        z.data_ptr(), centroids.data_ptr(), matrices.data_ptr(),
        float(inv_t2), float(lbd), float(log_eps), log_pi.data_ptr(), grad.data_ptr(),
        b, k, stream_handle(z.device),
    )
    raise_on_error("hmc_terms", code)
    hmc_terms.launches += 1
    return log_pi, grad


hmc_terms.launches = 0
