"""decode_mse: the decoder's last Dense, its sigmoid and the row-weighted MSE
in one pass, forward and backward.

Port of ``decode_mse`` (``rlvae_tpu/ops/recon_kernels.py:229``: the forward
``_fwd_pallas`` :165 and the backward ``_bwd_pallas`` :180, two
``pallas_call``s) as the hand-written CUDA kernels of ``csrc/decode_mse.cu``.
With h [M, K] the decoder's last hidden layer, W [N, K] and b [N] its output
layer (the port's ``nn.Linear`` layout; the TPU kernel takes W transposed),
x [M, N] the flattened targets and rw [M] the row weights:

    pre  = bf16(h) @ bf16(W)^T + b       (bf16 operands, fp32 sums)
    s    = sigmoid(pre),  d = s - x
    loss = sum_m rw[m] sum_n d[m, n]^2
    dp   = bf16(rw * 2 * d * s * (1 - s))
    dh   = g * round(dp @ bf16(W))       (round: to bf16 when h is bf16)
    dW   = g * dp^T @ bf16(h),  db = g * sum_m dp

with g the cotangent of the loss.  The reconstruction s is never stored.

What bounds it on an H100, and what the design does about it: see the
header of ``csrc/decode_mse.cu``.  In short, at the fast preset's training
shape (M = 128, K = 512, N = 12288) W (25 MB as fp32) and x dominate the
bytes, so each entry point reads W once per launch (a CTA keeps its columns
of W in shared memory as bf16 while it walks the rows), does every product
on the tensor cores (``mma.sync`` bf16 -> fp32), keeps no [M, N] tensor in
device memory, and sums across CTAs only in fixed orders (no atomics), so
results are bit-identical from run to run and in a CUDA-graph replay.
:func:`decode_geometry` is the launch geometry (CTAs along N, row groups,
the dh cluster size), a pure function of (M, N, K, SMs, cluster slots).

- :func:`decode_mse` (forward), :func:`decode_mse_bwd_dh` and
  :func:`decode_mse_bwd_dw` launch their kernels for CUDA tensors and run
  their plain versions (:func:`decode_mse_ref`, :func:`decode_mse_dh_ref`,
  :func:`decode_mse_dw_ref`) for CPU tensors; any other device raises.  Each
  wrapper's ``launches`` counts the calls that launched its kernel (the
  forward is two kernels, a tile pass and a fixed-order sum, and dh two
  when more than one cluster covers N; each counts once).
- :class:`DecodeMSE` is the ``torch.autograd.Function`` (the counterpart of
  the ``jax.custom_vjp`` at ``recon_kernels.py:228-253``): its forward is one
  :func:`decode_mse`, its backward one :func:`decode_mse_bwd_dh` and one
  :func:`decode_mse_bwd_dw`, which recompute the pre-activation from the
  saved (h, W, b, x, rw).  x and rw get no gradient.

The plain versions round h, W and dp to bf16 where the TPU kernel does and
form the products in fp32 (fp64 for fp64 targets) on the upcast values: a
bf16 ``torch.matmul`` would round its output to bf16, which the TPU kernel
does not.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from rlvae_tpu_torch.ops._launch import check_inputs, raise_on_error, stream_handle

MAX_HIDDEN = 512  # csrc/decode_mse.cu: MAX_K
# csrc/decode_mse.cu: rows per tile of the forward and dh (F_BM, H_BM), and
# the most 8-column blocks of N a CTA owns in the forward, dh and dW/db
# (F_N8, H_N8, W_N8)
FWD_ROWS, DH_ROWS = 64, 32
FWD_BLOCKS, DH_BLOCKS, DW_BLOCKS = 12, 14, 12
MAX_CLUSTER = 8  # the portable cluster size


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _bf16(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``t`` rounded to bf16 (round to nearest even), as ``dt``."""
    return t.to(torch.bfloat16).to(dt)


def _dp(h, w, b, x, rw, dt) -> torch.Tensor:
    """d(loss)/d(pre), rounded to bf16 as the TPU kernel's ``_dpre``."""
    s = torch.sigmoid(_bf16(h, dt) @ _bf16(w, dt).T + b.to(dt))
    d = s - x.to(dt)
    return _bf16(rw.to(dt)[:, None] * 2.0 * d * s * (1.0 - s), dt)


def decode_mse_ref(h, w, b, x, rw) -> torch.Tensor:
    """Plain PyTorch version of the forward: the loss, 0-d, fp32 (fp64 for
    fp64 targets)."""
    dt = _work_dtype(x)
    d = torch.sigmoid(_bf16(h, dt) @ _bf16(w, dt).T + b.to(dt)) - x.to(dt)
    return (rw.to(dt) * (d * d).sum(1)).sum()


def decode_mse_dh_ref(h, w, b, x, rw, g) -> torch.Tensor:
    """Plain PyTorch version of the dh backward: [M, K] in h's dtype."""
    dt = _work_dtype(x)
    dh = _dp(h, w, b, x, rw, dt) @ _bf16(w, dt)
    if h.dtype == torch.bfloat16:
        dh = _bf16(dh, dt)
    return (g.to(dt) * dh).to(h.dtype)


def decode_mse_dw_ref(h, w, b, x, rw, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dW/db backward: ([N, K], [N]), fp32."""
    dt = _work_dtype(x)
    dp = _dp(h, w, b, x, rw, dt)
    gd = g.to(dt)
    return (gd * (dp.T @ _bf16(h, dt))).to(w.dtype), (gd * dp.sum(0)).to(b.dtype)


def _shapes(name: str, h, w, b, x, rw) -> Tuple[int, int, int]:
    """(M, K, N) of h [M, K], w [N, K], b [N], x [M, N], rw [M]; raise on
    anything else."""
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: h [M,K] and w [N,K] expected, got {tuple(h.shape)}, "
                         f"{tuple(w.shape)}")
    m, k = h.shape
    n = w.shape[0]
    for arg, t, want in (("w", w, (n, k)), ("b", b, (n,)), ("x", x, (m, n)), ("rw", rw, (m,))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {want}")
    return m, k, n


def _kernel_args(name: str, h, w, b, x, rw, g=None):
    """Checked (M, K, N) and h as bf16 (the TPU kernel's ``_prep`` cast)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    m, k, n = _shapes(name, h, w, b, x, rw)
    extra = {} if g is None else {"g": g}
    check_inputs(name, x.device, w=w, b=b, x=x, rw=rw, **extra)
    if h.device != x.device:
        raise ValueError(f"{name}: h is on {h.device}, expected {x.device}")
    if h.requires_grad:
        raise RuntimeError(f"{name}: h requires grad, but the raw kernel wrapper is not "
                           "differentiable (use DecodeMSE)")
    if not (1 <= k <= MAX_HIDDEN and m >= 1 and n >= 1):
        raise ValueError(f"{name}: kernel takes 1 <= K <= {MAX_HIDDEN}, M, N >= 1; got "
                         f"M={m}, K={k}, N={n}")
    if g is not None and g.numel() != 1:
        raise ValueError(f"{name}: the cotangent must be a scalar, got {tuple(g.shape)}")
    return m, k, n, h.to(torch.bfloat16).contiguous()


class DecodeGeometry(NamedTuple):
    fwd_ctas: int        # forward: CTAs along N, each <= FWD_BLOCKS 8-column blocks
    fwd_row_groups: int  # forward: CTAs along M, each walking every that-many-th row tile
    dh_cluster: int      # dh: CTAs per cluster (rank-ordered sum in shared memory)
    dh_clusters: int     # dh: clusters along N; [clusters, M, K] partials when > 1
    dh_row_groups: int   # dh: clusters along M
    dw_ctas: int         # dW/db: CTAs along N, each walking all of M


def decode_geometry(m: int, n: int, k: int, sms: int,
                    cluster_slots: Callable[[int, int], int]) -> DecodeGeometry:
    """The launch geometry of decode+MSE for h [M, K] and W [N, K] on a card
    with ``sms`` SMs that holds ``cluster_slots(k, c)`` clusters of c dh CTAs
    at once (``cudaOccupancyMaxActiveClusters``; :func:`dh_cluster_slots`).

    Each entry point splits N into ranges of whole 8-column blocks, as few
    CTAs as the most blocks a CTA holds allow (one CTA per SM: W's columns
    fill its shared memory), so W crosses device memory once.  The forward
    adds row groups while the SMs last.  dh takes the largest cluster (<= 8)
    whose clusters the card holds in one wave (fewest partials), else 8, and
    adds row groups while the cluster slots last.  dW/db walks all of M."""
    if not (m >= 1 and n >= 1 and 1 <= k <= MAX_HIDDEN and sms >= 1):
        raise ValueError(f"decode_geometry: M={m}, N={n}, K={k}, SMs={sms}")
    blocks = -(-n // 8)
    fwd_ctas = -(-blocks // FWD_BLOCKS)
    fwd_row_groups = max(1, min(-(-m // FWD_ROWS), sms // fwd_ctas))
    need = -(-blocks // DH_BLOCKS)
    cluster = min(MAX_CLUSTER, need)
    for c in range(cluster, 0, -1):
        if -(-need // c) <= cluster_slots(k, c):
            cluster = c
            break
    clusters = -(-need // cluster)
    dh_row_groups = max(1, min(-(-m // DH_ROWS), cluster_slots(k, cluster) // clusters))
    return DecodeGeometry(fwd_ctas, fwd_row_groups, cluster, clusters, dh_row_groups,
                          -(-blocks // DW_BLOCKS))


_slots_lock = threading.Lock()
_slots: Dict[Tuple[int, int, int], int] = {}


def dh_cluster_slots(device: torch.device) -> Callable[[int, int], int]:
    """The card's ``cluster_slots`` for :func:`decode_geometry`, from the
    library (cached per device, padded K and cluster size)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index

    def slots(k: int, cluster: int) -> int:
        key = (index, -(-k // 64), cluster)
        with _slots_lock:
            if key not in _slots:
                import ctypes

                from rlvae_tpu_torch.ops.build import kernel_library

                out = (ctypes.c_int * 1)()
                with torch.cuda.device(index):
                    raise_on_error("decode_mse_dh_cluster_slots",
                                   kernel_library().decode_mse_dh_cluster_slots(k, cluster, out))
                _slots[key] = out[0]
            return _slots[key]

    return slots


def launch_decode_geometry(m: int, n: int, k: int, device: torch.device) -> DecodeGeometry:
    """The geometry the wrappers launch with on ``device``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return decode_geometry(m, n, k, sms, dh_cluster_slots(device))


def decode_mse(h, w, b, x, rw) -> torch.Tensor:
    """The loss, 0-d fp32; kernel on CUDA, plain version on CPU."""
    if x.device.type == "cpu":
        return decode_mse_ref(h, w, b, x, rw)
    m, k, n, hb = _kernel_args("decode_mse", h, w, b, x, rw)
    geo = launch_decode_geometry(m, n, k, x.device)
    partials = torch.empty((geo.fwd_ctas * geo.fwd_row_groups,), dtype=torch.float32,
                           device=x.device)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().decode_mse_fwd_f32(
        hb.data_ptr(), w.data_ptr(), b.data_ptr(), x.data_ptr(), rw.data_ptr(),
        partials.data_ptr(), loss.data_ptr(), m, k, n, geo.fwd_ctas, geo.fwd_row_groups,
        stream_handle(x.device))
    raise_on_error("decode_mse", code)
    decode_mse.launches += 1
    return loss


decode_mse.launches = 0


def decode_mse_bwd_dh(h, w, b, x, rw, g) -> torch.Tensor:
    """dh [M, K] in h's dtype; kernel on CUDA, plain version on CPU."""
    if x.device.type == "cpu":
        return decode_mse_dh_ref(h, w, b, x, rw, g)
    g = g.detach().to(torch.float32).reshape(()).contiguous()
    m, k, n, hb = _kernel_args("decode_mse_bwd_dh", h, w, b, x, rw, g)
    geo = launch_decode_geometry(m, n, k, x.device)
    workspace = (torch.empty((geo.dh_clusters, m, k), dtype=torch.float32, device=x.device)
                 if geo.dh_clusters > 1 else None)
    dh = torch.empty((m, k), dtype=torch.float32, device=x.device)
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().decode_mse_bwd_dh_f32(
        hb.data_ptr(), w.data_ptr(), b.data_ptr(), x.data_ptr(), rw.data_ptr(), g.data_ptr(),
        None if workspace is None else workspace.data_ptr(), dh.data_ptr(), m, k, n,
        geo.dh_cluster, geo.dh_clusters, geo.dh_row_groups, int(h.dtype == torch.bfloat16),
        stream_handle(x.device))
    raise_on_error("decode_mse_bwd_dh", code)
    decode_mse_bwd_dh.launches += 1
    return dh.to(h.dtype)


decode_mse_bwd_dh.launches = 0


def decode_mse_bwd_dw(h, w, b, x, rw, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW [N, K], db [N]) fp32; kernel on CUDA, plain version on CPU."""
    if x.device.type == "cpu":
        return decode_mse_dw_ref(h, w, b, x, rw, g)
    g = g.detach().to(torch.float32).reshape(()).contiguous()
    m, k, n, hb = _kernel_args("decode_mse_bwd_dw", h, w, b, x, rw, g)
    geo = launch_decode_geometry(m, n, k, x.device)
    dw = torch.empty((n, k), dtype=torch.float32, device=x.device)
    db = torch.empty((n,), dtype=torch.float32, device=x.device)
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().decode_mse_bwd_dw_f32(
        hb.data_ptr(), w.data_ptr(), b.data_ptr(), x.data_ptr(), rw.data_ptr(), g.data_ptr(),
        dw.data_ptr(), db.data_ptr(), m, k, n, geo.dw_ctas, stream_handle(x.device))
    raise_on_error("decode_mse_bwd_dw", code)
    decode_mse_bwd_dw.launches += 1
    return dw, db


decode_mse_bwd_dw.launches = 0


class DecodeMSE(torch.autograd.Function):
    """loss = decode_mse(h, W, b, x, rw), differentiable in h, W and b."""

    @staticmethod
    def forward(ctx, h, w, b, x, rw):
        h, w, b, x, rw = (t.detach() for t in (h, w, b, x, rw))
        ctx.save_for_backward(h, w, b, x, rw)
        return decode_mse(h, w, b, x, rw)

    @staticmethod
    def backward(ctx, g):
        h, w, b, x, rw = ctx.saved_tensors
        dh = decode_mse_bwd_dh(h, w, b, x, rw, g)
        dw, db = decode_mse_bwd_dw(h, w, b, x, rw, g)
        return dh, dw, db, None, None
