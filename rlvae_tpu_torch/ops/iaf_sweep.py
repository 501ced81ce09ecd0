"""The IAF-chain kernels on one card: checks and a sweep of their geometry.

    python -m rlvae_tpu_torch.ops.iaf_sweep [--sweep] [--n-sweeps N] [--out DIR]

Builds the kernels, prints the ``-Xptxas -v`` lines of the two IAF-chain
kernels and, for the shipped shape (D=16, H=256, NB=2, NH=3, NT=7) and for
NH=16, each launcher's geometry at B = 1, 16, 64 (R, C, clusters, shared
memory per CTA, resident or streamed, and how many such clusters the card
holds at once).  Then every instantiation (R = 1, 2, 4, 8; resident and
streamed) of the forward and the backward is held to its plain PyTorch
version at the near-identity init within 1e-4 of each output's scale, and
relaunched for bit-identity.  The profile build (``-DIAF_PROFILE``, a
library of its own) then sums clock64 laps per phase of a MADE pass on one
thread of each kernel, at the rule's geometry, converted to us with the
launch's CUDA-event time.  With ``--sweep`` it also times each (R, weights
resident or streamed) at B = 1, 16, 64 with CUDA events.  ``--n-sweeps N``
runs the backward's checks, profile and sweep with N adjoint sweeps per
block (D, the default, is exact); ``--n-sweeps 0`` selects the sequential
mode (JAX's ``adj_sweeps = 0``), whose profile is per reverse step: the
recomputed pass with the update's VJP, the VJP's products, gathers and
outer products, and dy's exchange and update.  One JSON line per
result; ``--out`` also writes them to ``DIR/iaf_sweep.jsonl``.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import subprocess
import sys
from pathlib import Path

import torch

from rlvae_tpu_torch.flows import TemporalFlows
from rlvae_tpu_torch.ops import iaf_kernels as ik
from rlvae_tpu_torch.ops._launch import stream_handle
from rlvae_tpu_torch.ops.build import kernel_library

D, H, NB, NH, NT = 16, 256, 2, 3, 7
BATCHES = (1, 16, 64)
ROWS = (1, 2, 4, 8)
RTOL = 1e-4
# the phases of the profile build (csrc/iaf_chain.cu FWD_PHASES,
# csrc/iaf_chain_bwd.cu BWD_PHASES); per MADE pass (backward: per sweep)
FWD_PHASES = ("block_start", "layer0", "hidden_products", "hidden_exchange",
              "output_partial_exchange", "y_update", "block_end", "total")
BWD_PHASES = ("block_start", "recompute", "wo_t_gate", "gather", "wh_t_product",
              "lam_partial_exchange", "lam_update", "grad_writes", "block_end", "total")
# the same slots in the sequential mode, per reverse step
SEQ_BWD_PHASES = ("block_start", "recompute_and_update_vjp", "wo_t_gate", "gather",
                  "wh_t_product", "dy_partial_exchange", "dy_update", "outer_products",
                  "block_end", "total")


def chain(dev, nh=NH, bias=0.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    flows = TemporalFlows(D, 8, H, NB, nh, log_var_bias_init=bias, generator=g)
    flows = flows.to(dev).requires_grad_(False)
    return ik.stack_chain([flows.flows[min(t, 7)] for t in range(NT)])


def fwd_at(lib, z0, w, r, stream_weights, ys=True):
    b, nt, nb = z0.shape[0], w[0].shape[0], w[0].shape[1]
    nh = w[2].shape[2] + 1
    z = torch.empty((nt, b, D), device=z0.device)
    ld = torch.empty((nt, b), device=z0.device)
    y = torch.empty((nt, nb, b, D), device=z0.device) if ys else None
    code = lib.iaf_chain_fwd_at_f32(z0.data_ptr(), *(x.data_ptr() for x in w), z.data_ptr(),
                                    ld.data_ptr(), y.data_ptr() if ys else None, b, D, H, nb,
                                    nh, nt, 0, r, stream_weights, stream_handle(z0.device))
    if code != 0:
        raise RuntimeError(f"iaf_chain_fwd_at_f32(R={r}) failed: cudaError_t {code}")
    return z, ld, y


def bwd_at(lib, ys, dz, dld, w, r, stream_weights, n_sweeps=D, z0=None):
    nt, nb, b, _ = ys.shape
    nh = w[2].shape[2] + 1
    dz0 = torch.empty((b, D), device=ys.device)
    parts = [torch.empty((-(-b // r), *x.shape), device=ys.device) for x in w]
    code = lib.iaf_chain_bwd_at_f32(ys.data_ptr(), dz.data_ptr(), dld.data_ptr(),
                                    z0.data_ptr() if n_sweeps == 0 else None,
                                    *(x.data_ptr() for x in w), dz0.data_ptr(),
                                    *(p.data_ptr() for p in parts), b, D, H, nb, nh, nt,
                                    n_sweeps, r, stream_weights, stream_handle(ys.device))
    if code != 0:
        raise RuntimeError(f"iaf_chain_bwd_at_f32(R={r}) failed: cudaError_t {code}")
    return dz0, tuple(p.sum(0) for p in parts)


def fwd_profile(lib, z0, w, prof):
    b, nt, nb = z0.shape[0], w[0].shape[0], w[0].shape[1]
    z = torch.empty((nt, b, D), device=z0.device)
    ld = torch.empty((nt, b), device=z0.device)
    code = lib.iaf_chain_fwd_profile_f32(z0.data_ptr(), *(x.data_ptr() for x in w), z.data_ptr(),
                                         ld.data_ptr(), None, b, D, H, nb, w[2].shape[2] + 1, nt,
                                         0, prof.data_ptr(), stream_handle(z0.device))
    if code != 0:
        raise RuntimeError(f"iaf_chain_fwd_profile_f32 failed: cudaError_t {code}")


def bwd_profile(lib, ys, dz, dld, w, prof, n_sweeps=D, z0=None):
    nt, nb, b, _ = ys.shape
    dz0 = torch.empty((b, D), device=ys.device)
    parts = ik.bwd_workspace(b, w)
    code = lib.iaf_chain_bwd_profile_f32(ys.data_ptr(), dz.data_ptr(), dld.data_ptr(),
                                         z0.data_ptr() if n_sweeps == 0 else None,
                                         *(x.data_ptr() for x in w), dz0.data_ptr(),
                                         *(p.data_ptr() for p in parts), b, D, H, nb,
                                         w[2].shape[2] + 1, nt, n_sweeps, prof.data_ptr(),
                                         stream_handle(ys.device))
    if code != 0:
        raise RuntimeError(f"iaf_chain_bwd_profile_f32 failed: cudaError_t {code}")


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def time_ms(fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--n-sweeps", type=int, default=D,
                    help="the backward's adjoint sweeps per block; 0: the sequential mode")
    ap.add_argument("--deadline-s", type=float, default=420.0,
                    help="dump every thread's stack and exit after this long")
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(args.deadline_s, exit=True)
    if not torch.cuda.is_available():
        print("iaf_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lines = []
    n = args.n_sweeps

    def emit(**rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lib = kernel_library()
    emit(kind="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         build_seconds=lib.seconds,
         ptxas=[ln.strip() for ln in lib.log.splitlines()
                if "Compiling entry" in ln or "registers" in ln or "spill" in ln])
    for b in BATCHES:
        emit(kind="geometry", batch=b, fwd=ik.launch_geometry(b, D, H, NH),
             bwd=ik.launch_geometry(b, D, H, NH, backward=True),
             fwd_nh16=ik.launch_geometry(b, D, H, 16),
             bwd_nh16=ik.launch_geometry(b, D, H, 16, backward=True))

    ok = True
    w = chain(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for b in (1, 7, 64):
        z0 = torch.randn(b, D, device=dev, generator=gen)
        dz = torch.randn(NT, b, D, device=dev, generator=gen)
        dld = torch.randn(NT, b, device=dev, generator=gen)
        z_p, ld_p, ys_p = ik.iaf_chain_fwd_ref(z0, *w, return_ys=True)
        dz0_p, g_p = ik.iaf_chain_bwd_ref(ys_p, dz, dld, *w, n_sweeps=n, z0=z0)
        for r in ROWS:
            for stream_weights in (0, 1):
                z, ld, ys = fwd_at(lib, z0, w, r, stream_weights)
                z2, ld2, ys2 = fwd_at(lib, z0, w, r, stream_weights)
                dz0, g = bwd_at(lib, ys_p, dz, dld, w, r, stream_weights, n, z0)
                dz0b, gb = bwd_at(lib, ys_p, dz, dld, w, r, stream_weights, n, z0)
                torch.cuda.synchronize()
                fe = max(rel_err(z, z_p), rel_err(ld, ld_p), rel_err(ys, ys_p))
                be = max(rel_err(a, e) for a, e in zip((dz0, *g), (dz0_p, *g_p)))
                same = (torch.equal(z, z2) and torch.equal(ld, ld2) and torch.equal(ys, ys2)
                        and torch.equal(dz0, dz0b) and all(map(torch.equal, g, gb)))
                good = fe <= RTOL and be <= RTOL and same
                ok &= good
                emit(kind="check", batch=b, rows=r, streamed=stream_weights, n_sweeps=n,
                     fwd_rel_err=fe, bwd_rel_err=be, relaunch_bit_identical=same, ok=good)

    # NH=16: its weights do not fit, the streamed instantiation runs
    w16 = chain(dev, nh=16)
    for b in (7, 64):
        z0 = torch.randn(b, D, device=dev, generator=gen)
        dz = torch.randn(NT, b, D, device=dev, generator=gen)
        dld = torch.randn(NT, b, device=dev, generator=gen)
        z_p, ld_p, ys_p = ik.iaf_chain_fwd_ref(z0, *w16, return_ys=True)
        dz0_p, g_p = ik.iaf_chain_bwd_ref(ys_p, dz, dld, *w16, n_sweeps=n, z0=z0)
        z, ld, ys = ik.iaf_chain_fwd(z0, *w16, return_ys=True)
        dz0, g = ik.iaf_chain_bwd(ys_p, dz, dld, *w16, n_sweeps=n, z0=z0)
        torch.cuda.synchronize()
        fe = max(rel_err(z, z_p), rel_err(ld, ld_p), rel_err(ys, ys_p))
        be = max(rel_err(a, e) for a, e in zip((dz0, *g), (dz0_p, *g_p)))
        good = fe <= RTOL and be <= RTOL
        ok &= good
        emit(kind="check", batch=b, nh=16, n_sweeps=n, geometry=ik.launch_geometry(b, D, H, 16),
             fwd_rel_err=fe, bwd_rel_err=be, ok=good)

    # where the time goes: clock64 sums per phase of cluster 0's rank 0
    # (the profile build), at the rule's geometry, converted to us with the
    # launch's own CUDA-event time; per MADE pass, per sweep (the final VJP
    # counted as one), or per reverse step of the sequential mode
    plib = kernel_library(profile=True)
    wm = chain(dev, bias=-2.0)
    for b in BATCHES:
        z0 = torch.randn(b, D, device=dev, generator=gen)
        dz = torch.randn(NT, b, D, device=dev, generator=gen)
        dld = torch.randn(NT, b, device=dev, generator=gen)
        _, _, ys = ik.iaf_chain_fwd(z0, *wm, return_ys=True)
        for name, phases, launch, passes in (
                ("fwd", FWD_PHASES, lambda pr: fwd_profile(plib, z0, wm, pr), NT * NB * D),
                ("bwd", SEQ_BWD_PHASES if n == 0 else BWD_PHASES,
                 lambda pr: bwd_profile(plib, ys, dz, dld, wm, pr, n, z0),
                 NT * NB * (D if n == 0 else n + 1))):
            prof = torch.zeros(len(phases), dtype=torch.int64, device=dev)
            ms = time_ms(lambda: launch(prof))
            cycles = prof.tolist()
            us_per_cycle = ms * 1e3 / max(cycles[-1], 1)
            emit(kind="profile", kernel=name, batch=b, rows=ik.cluster_rows(b), ms=ms,
                 n_sweeps=n if name == "bwd" else None,
                 passes=passes, cycles_total=cycles[-1],
                 us_per_pass={k: v * us_per_cycle / passes for k, v in zip(phases, cycles)})

    if args.sweep and ok:
        wm = chain(dev, bias=-2.0)
        for b in BATCHES:
            z0 = torch.randn(b, D, device=dev, generator=gen)
            dz = torch.randn(NT, b, D, device=dev, generator=gen)
            dld = torch.randn(NT, b, device=dev, generator=gen)
            _, _, ys = ik.iaf_chain_fwd(z0, *wm, return_ys=True)
            for r in ROWS:
                for stream_weights in (0, 1):
                    f_ms = time_ms(lambda: fwd_at(lib, z0, wm, r, stream_weights, ys=False))
                    b_ms = time_ms(lambda: bwd_at(lib, ys, dz, dld, wm, r, stream_weights, n,
                                                  z0), iters=5)
                    emit(kind="time", batch=b, rows=r, streamed=stream_weights, n_sweeps=n,
                         clusters=-(-b // r), fwd_ms=f_ms, bwd_ms=b_ms)
            emit(kind="time_default", batch=b,
                 fwd_ms=time_ms(lambda: ik.iaf_chain_fwd(z0, *wm)),
                 bwd_ms=time_ms(lambda: ik.iaf_chain_bwd(ys, dz, dld, *wm, n_sweeps=n, z0=z0),
                                iters=5))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        with open(args.out / "iaf_sweep.jsonl", "w") as fh:
            fh.writelines(json.dumps(rec) + "\n" for rec in lines)
    emit(kind="result", ok=ok)
    faulthandler.cancel_dump_traceback_later()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
