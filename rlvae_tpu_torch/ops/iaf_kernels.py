"""IAF chain: every temporal transition of the density-direction IAF in one
launch, forward and backward.

Port of ``_build_fused_iaf_chain`` (``rlvae_tpu/ops/iaf_kernels.py:504-680``)
as two hand-written CUDA kernels.  The weights arrive mask-premultiplied and
stacked per transition (the temporal chain's reused last flow appears once
per use):

    w0 [NT, NB, D, H]          b0 [NT, NB, H]
    wh [NT, NB, NH-1, H, H]    bh [NT, NB, NH-1, H]
    wo [NT, NB, H, 2D]         bo [NT, NB, 2D]

- :func:`iaf_chain_fwd` (``csrc/iaf_chain.cu``, replacing ``fwd_pallas``)
  returns z [NT, B, D] (each transition's output), ld [NT, B] (its
  log|det J|) and, when asked, the residual ys [NT, NB, B, D] (each block's
  output before the flip).  ``fp_iters = K > 0`` runs each block as the
  Jacobi fixed-point iteration of ``_transition_fwd_body``
  (``iaf_kernels.py:125-170``): K full MADE passes from y = 0, then one more
  whose (mu, s) give the output and the log-det; exact at K >= D - 1.
- :func:`iaf_chain_bwd` (``csrc/iaf_chain_bwd.cu``, replacing
  ``bwd_pallas``) is the adjoint VJP: from ys and the cotangents (dz, dld)
  it returns dz0 and the gradients of the six stacked weights, after
  ``n_sweeps`` adjoint sweeps per block (:func:`adjoint_sweeps`: D, exact,
  or K + 1 after a K-iteration forward, as ``get_fused_iaf_chain`` resolves
  ``adj_sweeps``, ``iaf_kernels.py:493-496``).  ``n_sweeps = 0`` is the
  sequential mode, ``_transition_bwd_body`` (``iaf_kernels.py:172-229``,
  ``adj_sweeps = 0``): D reverse steps per block, each a MADE pass
  recomputed at the output masked to the columns before the step's, the
  update's VJP and the weight gradients added up; it also reads z0, the
  chain's input (each block's input is z0 or a flipped residual).  It
  equals the adjoint mode up to fp32 order, except in the raw weight
  gradients that the MADE masks zero afterwards.
- :class:`IAFChain` is the ``torch.autograd.Function`` around the pair (the
  counterpart of the ``jax.custom_vjp`` at ``iaf_kernels.py:666-680``);
  :data:`ADJ_SWEEPS_OVERRIDE` picks its backward mode as JAX's does.
  Autograd through :func:`stack_chain` then applies the masks and sums the
  gradients of a flow that appears at several transitions.

Both kernels run as thread-block clusters: a cluster of ``CLUSTER_CTAS``
CTAs owns a group of rows for the whole chain, each CTA a column slice of
every layer's weights, held in shared memory where it fits
(``csrc/iaf_cluster.cuh``); :func:`chain_geometry` gives the launchers' R
and cluster count, :func:`launch_geometry` the rest from the library.  Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (:func:`iaf_chain_fwd_ref`, :func:`iaf_chain_bwd_ref`) for
CPU tensors; it raises on a shape the kernel does not take, or a cluster
the card cannot hold.  ``iaf_chain_fwd.launches`` and
``iaf_chain_bwd.launches`` count kernel launches;
``iaf_chain_bwd.sequential_launches`` counts those of the backward in its
sequential mode.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from rlvae_tpu_torch.flows.made import LOG_VAR_CLAMP
from rlvae_tpu_torch.ops._launch import check_inputs, raise_on_error, stream_handle

# csrc/iaf_cluster.cuh
MAX_DIM = 32  # MAX_D
MAX_HIDDEN = 256  # MAX_H
MAX_HIDDEN_LAYERS = 16  # MAX_NH (the backward)
CLUSTER_CTAS = 8  # C
CLUSTERS_PER_WAVE = 8
MAX_CLUSTER_ROWS = 8

# The backward mode of :class:`IAFChain`, read on every call, as JAX's
# ``ADJ_SWEEPS_OVERRIDE`` (``rlvae_tpu/ops/iaf_kernels.py:477-480``): None is
# auto (:func:`adjoint_sweeps`), an int the sweep count, 0 the sequential mode.
ADJ_SWEEPS_OVERRIDE: Optional[int] = None

Stack = Tuple[torch.Tensor, ...]


class ChainGeometry(NamedTuple):
    """The launch geometry of the IAF-chain kernels for a batch."""

    rows: int  # R: latent rows per cluster
    ctas: int  # C: CTAs per cluster
    clusters: int  # ceil(B / R): the grid, and the backward workspace's first dimension


def cluster_rows(b: int) -> int:
    """R: the smallest power of two up to 8 that keeps ceil(b / R) <= 8
    clusters (``cluster_rows`` in ``csrc/iaf_cluster.cuh``)."""
    r = 1
    while r < MAX_CLUSTER_ROWS and -(-b // r) > CLUSTERS_PER_WAVE:
        r *= 2
    return r


def chain_geometry(b: int) -> ChainGeometry:
    """R, C and the number of clusters the launchers of both kernels pick
    for a batch of ``b`` rows, whatever the shape; the backward's workspace
    has one slot per cluster."""
    r = cluster_rows(b)
    return ChainGeometry(r, CLUSTER_CTAS, -(-b // r))


def launch_geometry(b: int, d: int, h: int, nh: int, backward: bool = False,
                    fp_iters: int = 0) -> dict:
    """The launcher's own geometry at batch ``b`` and shape (d, h, nh),
    read from the kernel library (needs a card): R, C, clusters, dynamic
    shared memory per CTA, whether the weights are resident in it, and how
    many such clusters the card holds at once.  The forward's shared memory
    depends on the mode: ``fp_iters > 0`` exchanges all 2D output columns
    per pass, not two."""
    from rlvae_tpu_torch.ops.build import kernel_library

    lib, out = kernel_library(), (ctypes.c_int * 6)()
    ptr = ctypes.cast(out, ctypes.c_void_p)
    if backward:
        raise_on_error("iaf_chain_bwd_geometry", lib.iaf_chain_bwd_geometry(b, d, h, nh, ptr))
    else:
        raise_on_error("iaf_chain_fwd_geometry",
                       lib.iaf_chain_fwd_geometry(b, d, h, nh, fp_iters, ptr))
    keys = ("rows", "ctas", "clusters", "smem_bytes_per_cta", "weights_resident",
            "max_active_clusters")
    return dict(zip(keys, list(out)))


def chain_supported(d: int, h: int) -> bool:
    """True when the chain kernels take latent width ``d`` and hidden width
    ``h`` (D <= 32, H <= 256): the shape part of the JAX package's
    ``TemporalFlowConfig._use_fused`` (``rlvae_tpu/flows/temporal.py:80-97``).
    Past it the flows take the plain per-transition path, as JAX takes XLA."""
    return d <= MAX_DIM and h <= MAX_HIDDEN


def pad_hidden(stack: Stack) -> Stack:
    """``stack`` with its hidden width padded to a multiple of 4 (the kernels'
    H % 4 == 0) by zero-weight units, or ``stack`` itself.  Exact: a pad
    unit's pre-activation is 0 and it meets zero weights downstream, so every
    real sum only gains exact zeros; autograd slices the pads' gradients
    away."""
    w0, b0, wh, bh, wo, bo = stack
    p = -w0.shape[-1] % 4
    if p == 0:
        return stack
    pad = torch.nn.functional.pad
    return (pad(w0, (0, p)), pad(b0, (0, p)), pad(wh, (0, p, 0, p)), pad(bh, (0, p)),
            pad(wo, (0, 0, 0, p)), bo)


def stack_chain(chain: Sequence) -> Stack:
    """(w0, b0, wh, bh, wo, bo) from one IAF module per transition."""
    per_t = []
    for iaf in chain:
        blocks = list(iaf.blocks)
        last = blocks[0].n_layers - 1
        hidden = range(1, last)  # the [H, H] layers between layer 0 and the output
        h = blocks[0].weights[0].shape[1]
        per_t.append((
            torch.stack([blk.masked_weight(0) for blk in blocks]),
            torch.stack([blk.biases[0] for blk in blocks]),
            torch.stack([
                torch.stack([blk.masked_weight(li) for li in hidden]) if len(hidden)
                else blk.weights[0].new_zeros((0, h, h))
                for blk in blocks
            ]),
            torch.stack([
                torch.stack([blk.biases[li] for li in hidden]) if len(hidden)
                else blk.biases[0].new_zeros((0, h))
                for blk in blocks
            ]),
            torch.stack([blk.masked_weight(last) for blk in blocks]),
            torch.stack([blk.biases[last] for blk in blocks]),
        ))
    return tuple(torch.stack([p[i] for p in per_t]).contiguous() for i in range(6))


def _shapes(z0: torch.Tensor, w0, b0, wh, bh, wo, bo, name: str = "iaf_chain_fwd"):
    if z0.dim() != 2 or w0.dim() != 4:
        raise ValueError(f"{name}: z0 [B,D] and w0 [NT,NB,D,H] expected, got "
                         f"{tuple(z0.shape)}, {tuple(w0.shape)}")
    b, d = z0.shape
    nt, nb, d_w, h = w0.shape
    nh = wh.shape[2] + 1 if wh.dim() == 5 else -1
    expected = {
        "w0": (nt, nb, d, h), "b0": (nt, nb, h), "wh": (nt, nb, nh - 1, h, h),
        "bh": (nt, nb, nh - 1, h), "wo": (nt, nb, h, 2 * d), "bo": (nt, nb, 2 * d),
    }
    for arg, t in zip(expected, (w0, b0, wh, bh, wo, bo)):
        if tuple(t.shape) != expected[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {expected[arg]}")
    return b, d, h, nb, nh, nt


def _check_fp_iters(fp_iters: int) -> int:
    if int(fp_iters) != fp_iters or fp_iters < 0:
        raise ValueError(f"iaf_chain_fwd: fp_iters must be an integer >= 0, got {fp_iters!r}")
    return int(fp_iters)


def iaf_chain_fwd_ref(z0: torch.Tensor, w0, b0, wh, bh, wo, bo, return_ys: bool = False,
                      fp_iters: int = 0):
    """Plain PyTorch version: (z [NT, B, D], ld [NT, B]), plus ys [NT, NB, B, D]
    when ``return_ys``, in the weights' dtype.  ``fp_iters = K > 0``: each
    block by K Jacobi passes from y = 0 and a final one (module docstring)."""
    b, d, h, nb, nh, nt = _shapes(z0, w0, b0, wh, bh, wo, bo)
    fp_iters = _check_fp_iters(fp_iters)
    x = z0.to(w0.dtype)
    zs, lds, ys = [], [], []
    for t in range(nt):
        ld = torch.zeros(b, dtype=x.dtype, device=z0.device)
        for blk in range(nb):

            def made(y):  # (mu, clamped s) of this block at y
                a = y @ w0[t, blk] + b0[t, blk]  # no activation after layer 0
                for li in range(nh - 1):
                    a = torch.relu(a @ wh[t, blk, li] + bh[t, blk, li])
                out = a @ wo[t, blk] + bo[t, blk]
                return out[:, :d], torch.clamp(out[:, d:], -LOG_VAR_CLAMP, LOG_VAR_CLAMP)

            y = torch.zeros_like(x)
            if fp_iters > 0:
                # Jacobi: every column of the next iterate from the previous one
                for _ in range(fp_iters + 1):
                    mu, s = made(y)
                    y = (x - mu) * torch.exp(-s)
                ld = ld - s.sum(1)
            else:
                for i in range(d):
                    mu, s = made(y)
                    y = y.clone()
                    y[:, i] = (x[:, i] - mu[:, i]) * torch.exp(-s[:, i])
                    ld = ld - s[:, i]
            ys.append(y)
            x = torch.flip(y, dims=(1,))
        zs.append(x)
        lds.append(ld)
    if return_ys:
        return torch.stack(zs), torch.stack(lds), torch.stack(ys).reshape(nt, nb, b, d)
    return torch.stack(zs), torch.stack(lds)


def iaf_chain_fwd(z0: torch.Tensor, w0, b0, wh, bh, wo, bo, return_ys: bool = False,
                  fp_iters: int = 0):
    """(z [NT, B, D], ld [NT, B]) and, when ``return_ys``, ys [NT, NB, B, D];
    kernel on CUDA, plain version on CPU; ``fp_iters`` as for the plain version.
    While a program is exported, the inference call is the registered op
    (:mod:`rlvae_tpu_torch.ops.export_ops`)."""
    if not return_ys and torch.compiler.is_exporting():
        from rlvae_tpu_torch.ops import export_ops

        return export_ops.iaf_chain_fwd(z0, w0, b0, wh, bh, wo, bo, fp_iters)
    if z0.device.type == "cpu":
        return iaf_chain_fwd_ref(z0, w0, b0, wh, bh, wo, bo, return_ys, fp_iters)
    return _launch_fwd(z0, (w0, b0, wh, bh, wo, bo), return_ys, fp_iters=fp_iters)


def _launch_fwd(z0: torch.Tensor, weights: Stack, return_ys: bool = False,
                stream_weights: bool = False, fp_iters: int = 0):
    """The forward kernel on CUDA tensors.  ``stream_weights`` runs the
    instantiation that reads its weights from global memory even where they
    would fit in shared memory (for the checks that hold both to the plain
    version); the wrapper never asks for it."""
    if z0.device.type != "cuda":
        raise ValueError(f"iaf_chain_fwd: unsupported device {z0.device}")
    w0, b0, wh, bh, wo, bo = weights
    check_inputs("iaf_chain_fwd", z0.device, z0=z0, w0=w0, b0=b0, wh=wh, bh=bh, wo=wo, bo=bo)
    b, d, h, nb, nh, nt = _shapes(z0, w0, b0, wh, bh, wo, bo)
    fp_iters = _check_fp_iters(fp_iters)
    if not (1 <= d <= MAX_DIM and 4 <= h <= MAX_HIDDEN and h % 4 == 0 and nb >= 1
            and nh >= 1 and nt >= 1):
        raise ValueError(
            f"iaf_chain_fwd: kernel takes D<={MAX_DIM}, H<={MAX_HIDDEN} with H%4==0, "
            f"NB, NH, NT >= 1; got D={d}, H={h}, NB={nb}, NH={nh}, NT={nt}"
        )
    z = torch.empty((nt, b, d), dtype=torch.float32, device=z0.device)
    ld = torch.empty((nt, b), dtype=torch.float32, device=z0.device)
    ys = torch.empty((nt, nb, b, d), dtype=torch.float32, device=z0.device) if return_ys else None
    if b > 0:
        from rlvae_tpu_torch.ops.build import kernel_library

        args = (z0.data_ptr(), *(w.data_ptr() for w in weights), z.data_ptr(), ld.data_ptr(),
                ys.data_ptr() if return_ys else None, b, d, h, nb, nh, nt, fp_iters)
        lib = kernel_library()
        if stream_weights:
            code = lib.iaf_chain_fwd_at_f32(*args, cluster_rows(b), 1, stream_handle(z0.device))
        else:
            code = lib.iaf_chain_fwd_f32(*args, stream_handle(z0.device))
        raise_on_error("iaf_chain_fwd", code)
        iaf_chain_fwd.launches += 1
    return (z, ld, ys) if return_ys else (z, ld)


iaf_chain_fwd.launches = 0


Grads = Tuple[torch.Tensor, Stack]


def _bwd_shapes(ys, dz, dld, w0, b0, wh, bh, wo, bo):
    if ys.dim() != 4:
        raise ValueError(f"iaf_chain_bwd: ys [NT,NB,B,D] expected, got {tuple(ys.shape)}")
    b, d, h, nb, nh, nt = _shapes(ys[0, 0], w0, b0, wh, bh, wo, bo, "iaf_chain_bwd")
    for arg, t, want in (("ys", ys, (nt, nb, b, d)), ("dz", dz, (nt, b, d)),
                         ("dld", dld, (nt, b))):
        if tuple(t.shape) != want:
            raise ValueError(f"iaf_chain_bwd: {arg} has shape {tuple(t.shape)}, expected {want}")
    return b, d, h, nb, nh, nt


def adjoint_sweeps(d: int, fp_iters: int = 0) -> int:
    """The backward's sweeps per block after a forward of ``fp_iters``
    Jacobi iterations: D (exact: the adjoint system is nilpotent of index
    <= D) after the sequential forward, K + 1 after a K-iteration one."""
    return d if fp_iters == 0 else fp_iters + 1


def _check_sweeps(n_sweeps, d: int, z0: Optional[torch.Tensor] = None) -> int:
    """The sweep count (D when None); 0, the sequential mode, needs z0 [B, D]."""
    n_sweeps = d if n_sweeps is None else n_sweeps
    if int(n_sweeps) != n_sweeps or n_sweeps < 0:
        raise ValueError(f"iaf_chain_bwd: n_sweeps must be an integer >= 0, got {n_sweeps!r}")
    if n_sweeps == 0 and z0 is None:
        raise ValueError("iaf_chain_bwd: the sequential mode (n_sweeps=0) needs z0")
    return int(n_sweeps)


def iaf_chain_bwd_ref(ys: torch.Tensor, dz: torch.Tensor, dld: torch.Tensor,
                      w0, b0, wh, bh, wo, bo, n_sweeps: Optional[int] = None,
                      z0: Optional[torch.Tensor] = None) -> Grads:
    """Plain PyTorch version: (dz0 [B, D], (dw0, db0, dwh, dbh, dwo, dbo)).

    A direct transcription of ``_transition_bwd_adjoint_body``
    (``rlvae_tpu/ops/iaf_kernels.py:232-301``) with ``n_sweeps`` sweeps (D
    when None), run over the transitions in reverse; in the weights' dtype.
    ``n_sweeps = 0``: ``_transition_bwd_body`` (:172-229) instead, from the
    chain's input ``z0`` (:func:`_seq_bwd_ref`).
    """
    b, d, h, nb, nh, nt = _bwd_shapes(ys, dz, dld, w0, b0, wh, bh, wo, bo)
    n_sweeps = _check_sweeps(n_sweeps, d, z0)
    if n_sweeps == 0:
        return _seq_bwd_ref(ys, dz, dld, z0, w0, b0, wh, bh, wo, bo)
    dt = w0.dtype
    grads = tuple(torch.zeros_like(w) for w in (w0, b0, wh, bh, wo, bo))
    gw0, gb0, gwh, gbh, gwo, gbo = grads
    carry = torch.zeros((b, d), dtype=dt, device=ys.device)
    for t in reversed(range(nt)):
        dy = torch.flip(dz[t].to(dt) + carry, dims=(1,))  # adjoint of the final flip
        dld_t = dld[t].to(dt)[:, None]
        for blk in reversed(range(nb)):
            y = ys[t, blk].to(dt)
            W0, WH, WO = w0[t, blk], wh[t, blk], wo[t, blk]
            acts = [y @ W0 + b0[t, blk]]
            for li in range(nh - 1):
                acts.append(torch.relu(acts[-1] @ WH[li] + bh[t, blk, li]))
            s_pre = (acts[-1] @ WO + bo[t, blk])[:, d:]
            e = torch.exp(-torch.clamp(s_pre, -LOG_VAR_CLAMP, LOG_VAR_CLAMP))
            gate_s = (s_pre.abs() < LOG_VAR_CLAMP).to(dt)
            gates = [(a > 0).to(dt) for a in acts[1:]]

            def dout_of(lam):
                return torch.cat([-lam * e, gate_s * (-lam * y - dld_t)], dim=1)

            lam = dy
            for _ in range(n_sweeps):  # D sweeps are exact: the adjoint system is nilpotent
                da = dout_of(lam) @ WO.T
                for li in reversed(range(nh - 1)):
                    da = (gates[li] * da) @ WH[li].T
                lam = dy + da @ W0.T

            dout = dout_of(lam)  # one full VJP at the converged adjoint
            gwo[t, blk] = acts[-1].T @ dout
            gbo[t, blk] = dout.sum(0)
            da = dout @ WO.T
            for li in reversed(range(nh - 1)):
                g = gates[li] * da
                gwh[t, blk, li] = acts[li].T @ g
                gbh[t, blk, li] = g.sum(0)
                da = g @ WH[li].T
            gw0[t, blk] = y.T @ da
            gb0[t, blk] = da.sum(0)
            dx = lam * e
            dy = torch.flip(dx, dims=(1,)) if blk > 0 else dx
        carry = dy
    return carry, grads


def _seq_bwd_ref(ys, dz, dld, z0, w0, b0, wh, bh, wo, bo) -> Grads:
    """The sequential mode's plain version: ``_transition_bwd_body``
    (``rlvae_tpu/ops/iaf_kernels.py:172-229``) per transition, in reverse.
    Per block, D reverse steps i = D-1 ... 0: the MADE pass at the block's
    output masked to columns < i, the VJP of the update at column i, and
    the weight gradients of each step added up.  A block's input is z0 for
    the chain's first, else the previous block's output flipped."""
    b, d, h, nb, nh, nt = _bwd_shapes(ys, dz, dld, w0, b0, wh, bh, wo, bo)
    if tuple(z0.shape) != (b, d):
        raise ValueError(f"iaf_chain_bwd: z0 has shape {tuple(z0.shape)}, expected {(b, d)}")
    dt = w0.dtype
    grads = tuple(torch.zeros_like(w) for w in (w0, b0, wh, bh, wo, bo))
    gw0, gb0, gwh, gbh, gwo, gbo = grads
    col = torch.arange(d, device=ys.device)
    zero = torch.zeros((), dtype=dt, device=ys.device)
    carry = torch.zeros((b, d), dtype=dt, device=ys.device)
    for t in reversed(range(nt)):
        dy = torch.flip(dz[t].to(dt) + carry, dims=(1,))  # adjoint of the final flip
        dld_t = dld[t].to(dt)[:, None]
        for blk in reversed(range(nb)):
            y_out = ys[t, blk].to(dt)
            if blk > 0:
                x_b = torch.flip(ys[t, blk - 1].to(dt), dims=(1,))
            else:
                x_b = z0.to(dt) if t == 0 else torch.flip(ys[t - 1, nb - 1].to(dt), dims=(1,))
            W0, WH, WO = w0[t, blk], wh[t, blk], wo[t, blk]
            dx = torch.zeros_like(dy)
            for i in reversed(range(d)):
                sel, before = col == i, col < i
                y_in = torch.where(before, y_out, zero)
                acts = [y_in @ W0 + b0[t, blk]]  # no activation after layer 0
                for li in range(nh - 1):
                    acts.append(torch.relu(acts[-1] @ WH[li] + bh[t, blk, li]))
                out = acts[-1] @ WO + bo[t, blk]
                mu, s_pre = out[:, :d], out[:, d:]
                e = torch.exp(-torch.clamp(s_pre, -LOG_VAR_CLAMP, LOG_VAR_CLAMP))
                u = (x_b - mu) * e
                du = torch.where(sel, dy, zero)
                dx = dx + du * e
                ds = -du * u - torch.where(sel, dld_t, zero)
                ds_pre = torch.where(s_pre.abs() < LOG_VAR_CLAMP, ds, zero)
                dout = torch.cat([-du * e, ds_pre], dim=1)
                gwo[t, blk] += acts[-1].T @ dout
                gbo[t, blk] += dout.sum(0)
                da = dout @ WO.T
                for li in reversed(range(nh - 1)):
                    g = torch.where(acts[li + 1] > 0, da, zero)
                    gwh[t, blk, li] += acts[li].T @ g
                    gbh[t, blk, li] += g.sum(0)
                    da = g @ WH[li].T
                gw0[t, blk] += y_in.T @ da
                gb0[t, blk] += da.sum(0)
                dy = dy + torch.where(before, da @ W0.T, zero)
            dy = torch.flip(dx, dims=(1,)) if blk > 0 else dx
        carry = dy
    return carry, grads


def bwd_workspace(b: int, weights: Stack) -> list:
    """The backward kernel's weight-gradient partials: one [n_clusters, *w.shape]
    buffer per stacked weight, one slot per cluster of :func:`chain_geometry`."""
    n_clusters = chain_geometry(b).clusters
    return [torch.empty((n_clusters, *w.shape), dtype=torch.float32, device=w.device)
            for w in weights]


def iaf_chain_bwd(ys: torch.Tensor, dz: torch.Tensor, dld: torch.Tensor,
                  w0, b0, wh, bh, wo, bo, n_sweeps: Optional[int] = None,
                  z0: Optional[torch.Tensor] = None) -> Grads:
    """(dz0, stacked weight gradients) after ``n_sweeps`` adjoint sweeps per
    block (D when None; 0: the sequential mode, which reads the chain's
    input ``z0``); kernel on CUDA, plain version on CPU.

    The kernel writes each cluster's weight-gradient partials to its own
    slot of a [n_clusters, ...] workspace (:func:`chain_geometry`); they are
    summed here in cluster order, so the result does not depend on the order
    the clusters ran in.
    """
    if ys.device.type == "cpu":
        return iaf_chain_bwd_ref(ys, dz, dld, w0, b0, wh, bh, wo, bo, n_sweeps, z0)
    return _launch_bwd(ys, dz, dld, (w0, b0, wh, bh, wo, bo), n_sweeps=n_sweeps, z0=z0)


def _launch_bwd(ys: torch.Tensor, dz: torch.Tensor, dld: torch.Tensor, weights: Stack,
                stream_weights: bool = False, n_sweeps: Optional[int] = None,
                z0: Optional[torch.Tensor] = None) -> Grads:
    """The backward kernel on CUDA tensors; ``stream_weights`` as for
    :func:`_launch_fwd`."""
    if ys.device.type != "cuda":
        raise ValueError(f"iaf_chain_bwd: unsupported device {ys.device}")
    w0, b0, wh, bh, wo, bo = weights
    check_inputs("iaf_chain_bwd", ys.device, ys=ys, dz=dz, dld=dld, w0=w0, b0=b0, wh=wh,
                 bh=bh, wo=wo, bo=bo)
    b, d, h, nb, nh, nt = _bwd_shapes(ys, dz, dld, w0, b0, wh, bh, wo, bo)
    n_sweeps = _check_sweeps(n_sweeps, d, z0)
    if n_sweeps == 0:
        check_inputs("iaf_chain_bwd", ys.device, z0=z0)
        if tuple(z0.shape) != (b, d):
            raise ValueError(f"iaf_chain_bwd: z0 has shape {tuple(z0.shape)}, expected {(b, d)}")
    else:
        z0 = None  # the adjoint mode does not read it
    if not (1 <= d <= MAX_DIM and 4 <= h <= MAX_HIDDEN and h % 4 == 0 and nb >= 1
            and 1 <= nh <= MAX_HIDDEN_LAYERS and nt >= 1):
        raise ValueError(
            f"iaf_chain_bwd: kernel takes D<={MAX_DIM}, H<={MAX_HIDDEN} with H%4==0, "
            f"1<=NH<={MAX_HIDDEN_LAYERS}, NB, NT >= 1; got D={d}, H={h}, NB={nb}, "
            f"NH={nh}, NT={nt}"
        )
    dz0 = torch.empty((b, d), dtype=torch.float32, device=ys.device)
    if b == 0:
        return dz0, tuple(torch.zeros_like(w) for w in weights)
    parts = bwd_workspace(b, weights)
    from rlvae_tpu_torch.ops.build import kernel_library

    args = (ys.data_ptr(), dz.data_ptr(), dld.data_ptr(), None if z0 is None else z0.data_ptr(),
            *(w.data_ptr() for w in weights),
            dz0.data_ptr(), *(p.data_ptr() for p in parts), b, d, h, nb, nh, nt, n_sweeps)
    lib = kernel_library()
    if stream_weights:
        code = lib.iaf_chain_bwd_at_f32(*args, cluster_rows(b), 1, stream_handle(ys.device))
    else:
        code = lib.iaf_chain_bwd_f32(*args, parts[0].shape[0], stream_handle(ys.device))
    raise_on_error("iaf_chain_bwd", code)
    iaf_chain_bwd.launches += 1
    iaf_chain_bwd.sequential_launches += int(n_sweeps == 0)
    return dz0, tuple(p.sum(0) for p in parts)


iaf_chain_bwd.launches = 0
iaf_chain_bwd.sequential_launches = 0


class IAFChain(torch.autograd.Function):
    """(z, ld) = iaf_chain_fwd(z0, *weights, fp_iters=fp_iters), differentiable
    in z0 and the six stacked weights; the backward is :func:`iaf_chain_bwd`
    at :data:`ADJ_SWEEPS_OVERRIDE` sweeps when it is set (0: the sequential
    mode), else at :func:`adjoint_sweeps` sweeps, resolved on every call as
    JAX's ``get_fused_iaf_chain`` resolves ``adj_sweeps``.

    The adjoint reads only the residual ys (each block's output), so that is
    what the forward saves besides the weights (the sequential mode also
    z0); it asks the forward for ys only when some input needs a gradient,
    so inference keeps its launch.  At ``fp_iters = K < D - 1`` the gradient
    is the implicit adjoint at K + 1 sweeps, as JAX's kernel pair gives it,
    not autodiff through the iterations.
    """

    @staticmethod
    def forward(ctx, z0, w0, b0, wh, bh, wo, bo, fp_iters=0):
        weights = tuple(w.detach() for w in (w0, b0, wh, bh, wo, bo))
        if not any(ctx.needs_input_grad):
            return iaf_chain_fwd(z0.detach(), *weights, fp_iters=fp_iters)
        z, ld, ys = iaf_chain_fwd(z0.detach(), *weights, return_ys=True, fp_iters=fp_iters)
        n_sweeps = ADJ_SWEEPS_OVERRIDE
        if n_sweeps is None:
            n_sweeps = adjoint_sweeps(z0.shape[1], fp_iters)
        ctx.n_sweeps = _check_sweeps(n_sweeps, z0.shape[1], z0)
        saved = (z0.detach().contiguous(),) if ctx.n_sweeps == 0 else ()
        ctx.save_for_backward(ys, *weights, *saved)
        return z, ld

    @staticmethod
    def backward(ctx, dz, dld):
        ys, *weights = ctx.saved_tensors
        z0 = weights.pop() if ctx.n_sweeps == 0 else None
        dz0, grads = iaf_chain_bwd(ys, dz.contiguous(), dld.contiguous(), *weights,
                                   n_sweeps=ctx.n_sweeps, z0=z0)
        return (dz0, *grads, None)
