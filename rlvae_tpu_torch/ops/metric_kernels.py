"""The metric kernels: the chol-bundle, the HMC terms, the metric bundle
and G^{-1}.

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

**metric bundle**: (G^{-1}, L = chol G^{-1}, logdet G^{-1}, G) in one
launch, and **G^{-1}** alone.  Ports of ``metric_bundle_pallas``
(``metric_kernels.py:657``) and ``g_inv_pallas`` (:618) as the two kernels of
``csrc/metric_bundle.cu``.  With G^{-1} and L as above (diag = lbd):

    X = L^{-1} (forward substitution),  G = X^T X

**HMC partials**: one shard's part of the HMC terms, before the
cross-shard sum.  Port of ``hmc_partials_pallas`` (``metric_kernels.py:886``)
as ``csrc/hmc_partials.cu``.  With w_k as above, over this (shard of the)
bank:

    gi_part = sum_k w_k M_k                        (no + lbd I)
    v_j     = -2 inv_t2 sum_k w_k sum_i (c_k - z)_i M_k[i, j]

The centroid-sharded terms (``rlvae_tpu_torch/parallel/metric_parallel.py``)
sum both over the shards and finish with + lbd I, the Cholesky and G v.

Every matrix is i-major (the TPU kernels' slabs are j-major).  All five
kernels share one front half (``csrc/hmc_bank.cuh``) and are one launch
each at any size, with no workspace: the bank is split over the CTAs of a
thread-block cluster and the warps of a CTA, summed in rank and warp order,
at the geometry of :func:`hmc_geometry` for the kernel (G^{-1} at the
metric bundle's, so the two give the same bits).

**Latent widths.**  The kernels take every width the TPU kernels take, 1 <=
D <= :data:`FUSED_MAX_DIM` = 32 (JAX's ``_FUSED_MAX_DIM``), compiled at two
widths DP (:func:`bank_width`: 16 for D <= 16, 32 above).  A bank narrower
than its DP is zero-padded in its trailing indices (:func:`pad_bank`) once
per bank by the bank's owner (``CentroidMetric.kernel_bank``), which hands
the wrappers the padded pair in place of the bank (a wrapper given a bank of
width D pads it for that launch); z is read at its own width and every
output is D wide.  The padding is exact for
the real block (``csrc/hmc_bank.cuh``).  Past 32 the call sites take the
plain versions, as the JAX package takes XLA past ``fused_supported``:
:func:`fused_supported` is the predicate, decided from the shape before any
launch, and ``ops._launch.plain_route`` the plain call, which counts the
calls on CUDA tensors in ``plain_route.calls``.  The wrappers raise on a width their
kernels do not take, so a site that skips the predicate fails loudly.

Each wrapper (:func:`chol_bundle`, :func:`hmc_terms`, :func:`metric_bundle`,
:func:`g_inv`, :func:`hmc_partials`) launches its kernel for CUDA tensors and runs its plain
PyTorch version (``*_ref``) for CPU tensors; there is no other route.  Each
wrapper's ``launches`` counts the calls that launched its kernel.  While a
program is exported (``torch.compiler.is_exporting()``), the chol-bundle,
HMC terms, metric bundle and G^{-1} wrappers call their registered ops instead
(:mod:`rlvae_tpu_torch.ops.export_ops`), whose implementations are these
same wrappers.

:class:`CholBundle` and :class:`CholBundleLogdet` make the bundle's factor L
and its logdet differentiable, as ``chol_g_inv_fused`` does on the JAX side
(``metric_kernels.py:759-784``): the forward is one :func:`chol_bundle`
launch; the backward re-evaluates :func:`chol_bundle_ref` under autograd and
returns its VJP (the JAX package recomputes through its XLA path with
``jax.vjp``, not a kernel).  :class:`GInv` (G^{-1}) does the same with
:func:`g_inv_ref`.  :class:`MetricBundleG` (G) and :class:`MetricBundleGInvG`
(the pair (G^{-1}, G) of one launch), as ``g_fused`` (:788-805), map G's
cotangent onto G^{-1}'s lower triangle through the saved G (dG = -G dA G;
:func:`_g_inv_cotangent`) and take
:func:`g_inv_ref`'s VJP: the exact derivative, without a recompute through
the unrolled factorization.  As JAX's VJPs, the backward gives the
cotangents of ``z``, ``centroids`` and ``matrices``, each where the input
requires grad (the RHVAE's batch-local metric is built from the encoder's
mu and the metric net's L L^T).  The recompute reads the saved inputs
themselves, not detached copies, and builds its graph when the backward
runs under ``create_graph=True``, so a VJP is itself differentiable (the
RHVAE differentiates a loss through the gradient of its Hamiltonian).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from rlvae_tpu_torch.ops import linalg as _lin
from rlvae_tpu_torch.ops._launch import check_inputs, raise_on_error, stream_handle

# The widest latent the kernels take (rlvae_tpu/ops/metric_kernels.py
# _FUSED_MAX_DIM), and the widths they are compiled at (csrc/hmc_bank.cuh DP).
FUSED_MAX_DIM = 32
BANK_WIDTHS = (16, 32)


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


def _exported():
    """The registered ops (:mod:`rlvae_tpu_torch.ops.export_ops`), which a
    wrapper calls in place of its launch while a program is exported."""
    from rlvae_tpu_torch.ops import export_ops

    return export_ops


def fused_supported(d: int) -> bool:
    """True when the kernels take latent width ``d`` (D <= 32): the JAX
    package's ``fused_supported`` (``rlvae_tpu/ops/metric_kernels.py:77``),
    the routing predicate of every call site."""
    return d <= FUSED_MAX_DIM


def bank_width(d: int) -> int:
    """The compiled width DP (16 or 32) that serves latent width ``d``."""
    return BANK_WIDTHS[0] if d <= BANK_WIDTHS[0] else BANK_WIDTHS[1]


def pad_bank(centroids: torch.Tensor, matrices: torch.Tensor,
             width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bank zero-padded to ``width`` in its trailing indices: c [K,
    width], M [K, width, width] (the inputs themselves when already that
    wide); a copy outside autograd."""
    k, d = centroids.shape
    if d == width:
        return centroids, matrices
    with torch.no_grad():
        c = centroids.new_zeros((k, width))
        c[:, :d] = centroids
        m = matrices.new_zeros((k, width, width))
        m[:, :d, :d] = matrices
    return c, m


def _check_bank_shapes(name: str, z, centroids, matrices) -> Tuple[int, int, int]:
    """(B, K, D) of z [B, D] with 1 <= D <= 32 and a bank of width D or
    already padded to D's compiled width (c [K, W], M [K, W, W], W = D or
    ``bank_width(D)``); raise on anything else."""
    b, k = z.shape[0], centroids.shape[0]
    d = z.shape[1] if z.dim() == 2 else -1
    w = centroids.shape[1] if centroids.dim() == 2 else -1
    if (z.dim() != 2 or w not in (d, bank_width(d)) or centroids.shape != (k, w)
            or matrices.shape != (k, w, w)):
        raise ValueError(
            f"{name}: kernel takes z [B,D], c [K,D], M [K,D,D] (or the bank padded to "
            f"D's compiled width); got {tuple(z.shape)}, {tuple(centroids.shape)}, "
            f"{tuple(matrices.shape)}"
        )
    if not 1 <= d <= FUSED_MAX_DIM:
        raise ValueError(f"{name}: kernel takes 1 <= D <= {FUSED_MAX_DIM}, got D={d} "
                         "(past it the call sites take the plain version: fused_supported)")
    if k < 1:
        raise ValueError(f"{name}: empty centroid bank")
    return b, k, d


def _kernel_bank(name: str, z, centroids, matrices):
    """(B, K, D, c, M): the checked shapes and the bank the kernels read at
    D's compiled width (padded here, for this launch, when the caller gave
    it at width D)."""
    b, k, d = _check_bank_shapes(name, z, centroids, matrices)
    c, m = pad_bank(centroids, matrices, bank_width(d))
    _check_bank_alignment(name, c, m)
    return b, k, d, c, m


def _check_bank_alignment(name: str, centroids: torch.Tensor, matrices: torch.Tensor) -> None:
    """The kernels stage the bank with bulk copies, which need 16-byte aligned
    sources (every row of c and M is 16-byte aligned when its start is)."""
    for arg, t in (("centroids", centroids), ("matrices", matrices)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary")


def chol_bundle(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
    inv_t2: float, diag: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, logdet) of G^{-1}(z) + (diag - lbd) I; kernel on CUDA, plain on CPU."""
    if torch.compiler.is_exporting():
        return _exported().chol_bundle(z, centroids, matrices, inv_t2, diag)
    if z.device.type == "cpu":
        return chol_bundle_ref(z, centroids, matrices, inv_t2, diag)
    if z.device.type != "cuda":
        raise ValueError(f"chol_bundle: unsupported device {z.device}")
    check_inputs("chol_bundle", z.device, z=z, centroids=centroids, matrices=matrices)
    b, k, d, c, m = _kernel_bank("chol_bundle", z, centroids, matrices)
    l = torch.empty((b, d, d), dtype=torch.float32, device=z.device)
    logdet = torch.empty((b,), dtype=torch.float32, device=z.device)
    if b == 0:
        return l, logdet
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().chol_bundle_f32(
        z.data_ptr(), c.data_ptr(), m.data_ptr(),
        float(inv_t2), float(diag), l.data_ptr(), logdet.data_ptr(),
        b, k, d, stream_handle(z.device),
    )
    raise_on_error("chol_bundle", code)
    chol_bundle.launches += 1
    return l, logdet


chol_bundle.launches = 0


def _save(ctx, z, centroids, matrices, inv_t2: float, diag: float, *outputs) -> None:
    ctx.save_for_backward(z, centroids, matrices, *outputs)
    ctx.scalars = (inv_t2, diag)


def _detached(z, centroids, matrices, bank=None):
    """The kernel wrappers' inputs: the raw wrappers take no tensor that
    requires grad.  ``bank``, where given, is the pair (c, M) at the
    kernels' width (``CentroidMetric.kernel_bank``), which the launch reads
    in place of the bank; the backward recomputes from the bank itself."""
    c, m = (centroids, matrices) if bank is None else bank
    return z.detach(), c.detach(), m.detach()


def _recompute_vjp(ctx, plain, *cotangents):
    """VJP of ``plain(z, centroids, matrices, inv_t2, diag)`` (one output, or
    a tuple of them), the kernel's plain version re-evaluated under autograd
    from the saved inputs (the JAX package recomputes through its XLA path):
    the cotangent of each of z, centroids and matrices that requires grad,
    else None.  Under ``create_graph=True`` (grad mode on in the backward)
    the result carries its own graph.  The Functions' scalars and kernel
    bank take no cotangent."""
    saved = ctx.saved_tensors[:3]
    need = ctx.needs_input_grad[:3]
    if not any(need):
        return None, None, None, None, None, None
    with torch.enable_grad():
        # each input that needs grad enters as an alias of its own (a view),
        # so the grads are partials even where z was computed from the bank
        # (the RHVAE's z from the encoder's mu); the others enter detached
        args = [t.view_as(t) if n else t.detach() for t, n in zip(saved, need)]
        out = plain(*args, *ctx.scalars)
        outs = out if isinstance(out, tuple) else (out,)
        grads = iter(torch.autograd.grad(outs, [a for a, n in zip(args, need) if n], cotangents,
                                         create_graph=torch.is_grad_enabled()))
    return (*(next(grads) if n else None for n in need), None, None, None)


class CholBundle(torch.autograd.Function):
    """L = chol_bundle(z, ...)[0], differentiable in z, centroids and matrices."""

    @staticmethod
    def forward(ctx, z, centroids, matrices, inv_t2: float, diag: float, bank=None):
        _save(ctx, z, centroids, matrices, inv_t2, diag)
        return chol_bundle(*_detached(z, centroids, matrices, bank), inv_t2, diag)[0]

    @staticmethod
    def backward(ctx, dl):
        return _recompute_vjp(ctx, lambda *a: chol_bundle_ref(*a)[0], dl)


class CholBundleLogdet(torch.autograd.Function):
    """logdet = chol_bundle(z, ...)[1], differentiable in z, centroids and matrices."""

    @staticmethod
    def forward(ctx, z, centroids, matrices, inv_t2: float, diag: float, bank=None):
        _save(ctx, z, centroids, matrices, inv_t2, diag)
        return chol_bundle(*_detached(z, centroids, matrices, bank), inv_t2, diag)[1]

    @staticmethod
    def backward(ctx, dld):
        return _recompute_vjp(ctx, lambda *a: chol_bundle_ref(*a)[1], dld)


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


# The geometry of the kernels of csrc/hmc_bank.cuh's front half at width 16:
# centroids per staged chunk, the limits of rows per CTA and CTAs per cluster
# (the portable cluster size), and the fewest chunks a CTA sums before the
# bank is split over a cluster.  Width 32 stages 2 centroids a chunk and
# takes at most 4 rows per CTA (HMC_LAYOUTS: chunk, rows).
HMC_CHUNK, HMC_MAX_ROWS, HMC_MAX_CTAS, HMC_MIN_CTA_CHUNKS = 4, 8, 8, 32
HMC_LAYOUTS = {16: (HMC_CHUNK, HMC_MAX_ROWS), 32: (2, 4)}
# Each kernel's instance of the rule (csrc/hmc_bank.cuh BankKernel): B4 and B8
# one, B1 one, B6 and B7 one (G^{-1} launches at the metric bundle's geometry);
# the rule takes the compiled width (bank_width) as an argument of its own.
BANK_KERNELS = {"hmc_terms": 0, "hmc_partials": 0, "chol_bundle": 1, "metric_bundle": 2,
                "g_inv": 2}


def hmc_max_warps(rows: int, kernel: str = "hmc_terms", d: int = 16) -> int:
    """Warps a CTA of ``rows`` rows of ``kernel`` may have: 16, or 8 for the
    HMC terms and partials at 8 rows (registers); 8 at width 32 (shared
    memory and registers)."""
    if bank_width(d) == 32:
        return 8
    return 8 if BANK_KERNELS[kernel] == 0 and rows > 4 else 16


class HMCGeometry(NamedTuple):
    rows: int      # rows of z per CTA (blocked in each warp's registers)
    warps: int     # warps per CTA, each summing one range of the CTA's chunks
    ctas: int      # CTAs per cluster, each summing one range of the bank's chunks
    clusters: int  # ceil(B / rows)


def hmc_geometry(b: int, k: int, sms: int, cluster_slots: Callable[[int, int, int], int],
                 kernel: str = "hmc_terms", d: int = 16) -> HMCGeometry:
    """The launch geometry of ``kernel`` (a key of ``BANK_KERNELS``) for B
    rows, K centroids and latent width ``d`` on a card with ``sms`` SMs that
    holds ``cluster_slots(rows, warps, ctas)`` clusters of that kernel's
    shape at once; the launchers' own rule (``hmc_geometry`` in
    ``csrc/hmc_bank.cuh``, where the slots come from
    ``cudaOccupancyMaxActiveClusters``; :func:`launch_hmc_geometry` asks it).
    chunks = ceil(K / chunk) (chunk of ``HMC_LAYOUTS`` at d's width); C_max =
    min(8, chunks // HMC_MIN_CTA_CHUNKS), at least 1; the rows per CTA the
    smallest of 1, 2, 4, 8 (at most the width's rows) whose ceil(B / rows)
    clusters of C_max CTAs fit within the SMs (the most if none does); the
    warps enough for one chunk each, at least one per row for the epilogue,
    at most :func:`hmc_max_warps`; the cluster size the largest C <= C_max
    whose clusters the card holds at once, else 1."""
    chunk, max_rows = HMC_LAYOUTS[bank_width(d)]
    chunks = -(-k // chunk)
    c_max = max(1, min(HMC_MAX_CTAS, chunks // HMC_MIN_CTA_CHUNKS))
    rows = 1
    while rows < max_rows and -(-b // rows) * c_max > sms:
        rows *= 2
    clusters = -(-b // rows)
    warps = min(hmc_max_warps(rows, kernel, d), max(rows, -(-chunks // c_max)))
    ctas = c_max
    while ctas > 1 and clusters > cluster_slots(rows, warps, ctas):
        ctas -= 1
    return HMCGeometry(rows, warps, ctas, clusters)


def launch_hmc_geometry(b: int, k: int, device: torch.device,
                        kernel: str = "hmc_terms", d: int = 16) -> HMCGeometry:
    """The geometry the launcher of ``kernel`` takes for (B, K) at latent
    width ``d`` on ``device``, from the library's own rule."""
    import ctypes

    from rlvae_tpu_torch.ops.build import kernel_library

    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        raise_on_error("hmc_geometry", kernel_library().hmc_geometry(
            b, k, torch.cuda.get_device_properties(device).multi_processor_count,
            BANK_KERNELS[kernel], bank_width(d), out))
    return HMCGeometry(*out)


def hmc_cluster_slots(device: torch.device, kernel: str = "hmc_terms",
                      d: int = 16) -> Callable[[int, int, int], int]:
    """The card's ``cluster_slots`` of ``kernel`` at latent width ``d`` for
    :func:`hmc_geometry`: how many clusters of (rows, warps, ctas) it holds
    at once, from the library."""
    import ctypes

    from rlvae_tpu_torch.ops.build import kernel_library

    def slots(rows: int, warps: int, ctas: int) -> int:
        out = (ctypes.c_int * 1)()
        with torch.cuda.device(device):
            raise_on_error("hmc_cluster_slots", kernel_library().hmc_cluster_slots(
                rows, warps, ctas, BANK_KERNELS[kernel], bank_width(d), out))
        return out[0]

    return slots


def hmc_terms(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
    inv_t2: float, lbd: float, log_eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log pi [B], grad [B, D]) of the HMC target; kernel on CUDA, plain on CPU."""
    if torch.compiler.is_exporting():
        return _exported().hmc_terms(z, centroids, matrices, inv_t2, lbd, log_eps)
    if z.device.type == "cpu":
        return hmc_terms_ref(z, centroids, matrices, inv_t2, lbd, log_eps)
    if z.device.type != "cuda":
        raise ValueError(f"hmc_terms: unsupported device {z.device}")
    check_inputs("hmc_terms", z.device, z=z, centroids=centroids, matrices=matrices)
    b, k, d, c, m = _kernel_bank("hmc_terms", z, centroids, matrices)
    log_pi = torch.empty((b,), dtype=torch.float32, device=z.device)
    grad = torch.empty((b, d), dtype=torch.float32, device=z.device)
    if b == 0:
        return log_pi, grad
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().hmc_terms_f32(
        z.data_ptr(), c.data_ptr(), m.data_ptr(),
        float(inv_t2), float(lbd), float(log_eps), log_pi.data_ptr(), grad.data_ptr(),
        b, k, d, stream_handle(z.device),
    )
    raise_on_error("hmc_terms", code)
    hmc_terms.launches += 1
    return log_pi, grad


hmc_terms.launches = 0


# ---------------------------------------------------------------------------
# Metric bundle and G^{-1}
# ---------------------------------------------------------------------------


def g_inv_ref(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
    inv_t2: float, lbd: float,
) -> torch.Tensor:
    """Plain PyTorch version: G^{-1} [B, D, D], as the JAX package's XLA
    ``gm.g_inv`` (one [B, K] @ [K, D*D] product).  fp64 banks give the fp64
    evaluation."""
    k, d = centroids.shape
    z = z.to(centroids.dtype)
    diff = z[:, None, :] - centroids[None, :, :]  # [B, K, D]
    w = torch.exp(-(diff * diff).sum(-1) * inv_t2)
    gi = (w @ matrices.reshape(k, d * d)).reshape(-1, d, d)
    return gi + lbd * torch.eye(d, dtype=gi.dtype, device=gi.device)


def metric_bundle_ref(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
    inv_t2: float, lbd: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (G^{-1}, L, logdet, G), as the JAX package's XLA
    path (``g_inv``, ``cholesky_small``, ``logdet_from_chol``, and G by
    ``inv_psd_small``'s solves against I on the same factor)."""
    gi = g_inv_ref(z, centroids, matrices, inv_t2, lbd)
    l = _lin.cholesky_small(gi)
    eye = torch.eye(gi.shape[-1], dtype=gi.dtype, device=gi.device).expand(gi.shape)
    g = _lin.tri_solve_upper_t(l, _lin.tri_solve_lower(l, eye))
    return gi, l, _lin.logdet_from_chol(l), g


def metric_bundle(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
    inv_t2: float, lbd: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(G^{-1}, L, logdet, G) of G^{-1}(z); kernel on CUDA, plain on CPU."""
    if torch.compiler.is_exporting():
        return _exported().metric_bundle(z, centroids, matrices, inv_t2, lbd)
    if z.device.type == "cpu":
        return metric_bundle_ref(z, centroids, matrices, inv_t2, lbd)
    if z.device.type != "cuda":
        raise ValueError(f"metric_bundle: unsupported device {z.device}")
    check_inputs("metric_bundle", z.device, z=z, centroids=centroids, matrices=matrices)
    b, k, d, c, m = _kernel_bank("metric_bundle", z, centroids, matrices)
    gi, l, g = (torch.empty((b, d, d), dtype=torch.float32, device=z.device) for _ in range(3))
    logdet = torch.empty((b,), dtype=torch.float32, device=z.device)
    if b == 0:
        return gi, l, logdet, g
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().metric_bundle_f32(
        z.data_ptr(), c.data_ptr(), m.data_ptr(), float(inv_t2), float(lbd),
        gi.data_ptr(), l.data_ptr(), logdet.data_ptr(), g.data_ptr(), b, k, d,
        stream_handle(z.device),
    )
    raise_on_error("metric_bundle", code)
    metric_bundle.launches += 1
    return gi, l, logdet, g


metric_bundle.launches = 0


def g_inv(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
    inv_t2: float, lbd: float,
) -> torch.Tensor:
    """G^{-1}(z) [B, D, D]; kernel on CUDA, plain on CPU."""
    if torch.compiler.is_exporting():
        return _exported().g_inv(z, centroids, matrices, inv_t2, lbd)
    if z.device.type == "cpu":
        return g_inv_ref(z, centroids, matrices, inv_t2, lbd)
    if z.device.type != "cuda":
        raise ValueError(f"g_inv: unsupported device {z.device}")
    check_inputs("g_inv", z.device, z=z, centroids=centroids, matrices=matrices)
    b, k, d, c, m = _kernel_bank("g_inv", z, centroids, matrices)
    gi = torch.empty((b, d, d), dtype=torch.float32, device=z.device)
    if b == 0:
        return gi
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().g_inv_f32(
        z.data_ptr(), c.data_ptr(), m.data_ptr(), float(inv_t2), float(lbd),
        gi.data_ptr(), b, k, d, stream_handle(z.device),
    )
    raise_on_error("g_inv", code)
    g_inv.launches += 1
    return gi


g_inv.launches = 0


def _g_inv_cotangent(g: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
    """The cotangent of A = G^{-1} from G's.  G = A^{-1} gives dG = -G dA G,
    so S = -G^T dG G^T; and G reads only A's lower triangle (the unrolled
    Cholesky's, on the JAX side as in the plain version), so S folds onto
    it: tril(S) + tril(S^T, -1).  The exact derivative JAX's VJP takes
    through its solves, from three products of the saved G instead of a
    recompute through the factorization (~10^3 autograd nodes a call)."""
    gt = g.transpose(-1, -2)
    s = -(gt @ dg @ gt)
    return torch.tril(s) + torch.tril(s.transpose(-1, -2), -1)


class MetricBundleG(torch.autograd.Function):
    """G = metric_bundle(z, ...)[3], differentiable in z, centroids and
    matrices.  The backward maps G's cotangent onto G^{-1}'s with the saved G
    (:func:`_g_inv_cotangent`) and takes the VJP of G^{-1}'s plain version
    from the saved inputs; saved as an output of this Function, G carries
    the graph of a second derivative back through it."""

    @staticmethod
    def forward(ctx, z, centroids, matrices, inv_t2: float, lbd: float, bank=None):
        g = metric_bundle(*_detached(z, centroids, matrices, bank), inv_t2, lbd)[3]
        _save(ctx, z, centroids, matrices, inv_t2, lbd, g)
        return g

    @staticmethod
    def backward(ctx, dg):
        return _recompute_vjp(ctx, g_inv_ref, _g_inv_cotangent(ctx.saved_tensors[3], dg))


class MetricBundleGInvG(torch.autograd.Function):
    """(G^{-1}, G) = metric_bundle(z, ...)[0, 3] from one launch,
    differentiable in z, centroids and matrices (the Christoffel symbols
    read both); the backward as :class:`MetricBundleG`'s, with G^{-1}'s own
    cotangent added."""

    @staticmethod
    def forward(ctx, z, centroids, matrices, inv_t2: float, lbd: float, bank=None):
        gi, _, _, g = metric_bundle(*_detached(z, centroids, matrices, bank), inv_t2, lbd)
        _save(ctx, z, centroids, matrices, inv_t2, lbd, g)
        return gi, g

    @staticmethod
    def backward(ctx, dgi, dg):
        return _recompute_vjp(ctx, g_inv_ref, dgi + _g_inv_cotangent(ctx.saved_tensors[3], dg))


class GInv(torch.autograd.Function):
    """G^{-1} = g_inv(z, ...), differentiable in z, centroids and matrices."""

    @staticmethod
    def forward(ctx, z, centroids, matrices, inv_t2: float, lbd: float, bank=None):
        _save(ctx, z, centroids, matrices, inv_t2, lbd)
        return g_inv(*_detached(z, centroids, matrices, bank), inv_t2, lbd)

    @staticmethod
    def backward(ctx, dgi):
        return _recompute_vjp(ctx, g_inv_ref, dgi)


# ---------------------------------------------------------------------------
# HMC partials (one shard of the bank)
# ---------------------------------------------------------------------------


def hmc_partials_ref(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor, inv_t2: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (gi_part [B, D, D] without + lbd I, v [B, D]),
    as the XLA arm of the JAX package's ``_partial_terms``
    (``rlvae_tpu/parallel/metric_parallel.py:122-131``).  fp64 banks give the
    fp64 evaluation."""
    k, d = centroids.shape
    z = z.to(centroids.dtype)
    diff = z[:, None, :] - centroids[None, :, :]  # [B, K, D]
    w = torch.exp(-(diff * diff).sum(-1) * inv_t2)  # [B, K]
    gi = (w @ matrices.reshape(k, d * d)).reshape(-1, d, d)
    # the weighted differences contracted with M, never sum(w c M) - sum(w z M)
    wd = w[:, :, None] * (centroids[None, :, :] - z[:, None, :])  # [B, K, D]
    v = (-2.0 * inv_t2) * (wd.reshape(-1, k * d) @ matrices.reshape(k * d, d))
    return gi, v


def hmc_partials(
    z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor, inv_t2: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gi_part [B, D, D], v [B, D]) over this (shard of the) bank; kernel on
    CUDA, plain on CPU."""
    if z.device.type == "cpu":
        return hmc_partials_ref(z, centroids, matrices, inv_t2)
    if z.device.type != "cuda":
        raise ValueError(f"hmc_partials: unsupported device {z.device}")
    check_inputs("hmc_partials", z.device, z=z, centroids=centroids, matrices=matrices)
    b, k, d, c, m = _kernel_bank("hmc_partials", z, centroids, matrices)
    gi = torch.empty((b, d, d), dtype=torch.float32, device=z.device)
    v = torch.empty((b, d), dtype=torch.float32, device=z.device)
    if b == 0:
        return gi, v
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().hmc_partials_f32(
        z.data_ptr(), c.data_ptr(), m.data_ptr(), float(inv_t2),
        gi.data_ptr(), v.data_ptr(), b, k, d, stream_handle(z.device),
    )
    raise_on_error("hmc_partials", code)
    hmc_partials.launches += 1
    return gi, v


hmc_partials.launches = 0
