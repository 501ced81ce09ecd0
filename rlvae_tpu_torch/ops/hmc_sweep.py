"""The manifold-HMC kernels (B4 ``hmc_terms``, B8 ``hmc_partials``) on one
card: checks, a phase profile and a sweep of their geometry.

    python -m rlvae_tpu_torch.ops.hmc_sweep [--sweep] [--out DIR]

Builds the kernels and prints the ``-Xptxas -v`` lines of the HMC kernels,
then the rule's geometry (``metric_kernels.hmc_geometry``, held to the
library's ``hmc_geometry``) at B = 1, 37, 64, 1000 and K = 37, 40, 50, 200,
2000, 20 000.  Each kernel is then held to its plain PyTorch version (the
tolerances of ``chip_smoke.py``) at the rule's geometry and at forced ones
(every rows per CTA with one CTA and with a cluster of 8, 16 warps, and 3
warps in clusters of 2), and
relaunched for bit-identity.  The profile build (``-DHMC_PROFILE``, a
library of its own) then sums clock64 laps per phase (staging waits,
weights, the two weighted sums, the warp, CTA and cluster reductions, the
Cholesky and the rest of the epilogue) on thread 0 of CTA 0 at the rule's
geometry for B = 1, 64, 1000 and K = 50, 200, 20 000, in cycles and in us
at the card's largest SM clock, beside the launch's device time.  With ``--sweep`` it also times every geometry
(rows 1, 2, 4, 8 x CTAs per cluster 1, 2, 4, 8 x warps 4, 8, 16; rows 4
and 8 only at B = 1000) at those shapes.  Times are device time per launch: a CUDA
graph of ``GRAPH_LAUNCHES`` launches, replayed, timed with CUDA events (no
host issue time inside).  One JSON line per result; ``--out`` also writes
them to ``DIR/hmc_sweep.jsonl``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import faulthandler
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from rlvae_tpu_torch.ops import metric_kernels as mk
from rlvae_tpu_torch.ops._launch import stream_handle
from rlvae_tpu_torch.ops.build import kernel_library

D = 16
LOG_EPS = float(np.log(np.float32(1e-10)))
INV_T2, LBD = 4.0, 0.01
GEOMETRY_BATCHES = (1, 37, 64, 1000)
GEOMETRY_BANKS = (37, 40, 50, 200, 2000, 20_000)
BATCHES = (1, 64, 1000)
BANKS = (50, 200, 20_000)
GRAPH_LAUNCHES = 20
# kernel vs plain: log pi abs, grad and v relative to scale, gi_part relative
# to max(1, |plain|) (chip_smoke.py's HMC_LP_ATOL, HMC_RTOL, PARTIALS_TOL)
LP_ATOL, GRAD_RTOL, GI_RTOL, V_RTOL = 1e-5, 1e-4, 1e-5, 1e-4
# the phases of the profile build (csrc/hmc_bank.cuh HMC_PHASES)
PHASES = ("setup", "stage_wait", "weights", "sums", "warp_reduce", "cta_reduce",
          "cluster_reduce", "cholesky", "finish", "total")


def bank(k: int, seed: int = 0):
    """A seeded bank of K centroids and SPD matrices (a a^T / 16 + 0.1 I)."""
    rng = np.random.default_rng(seed + k)
    c = rng.normal(size=(k, D)).astype(np.float32)
    a = (rng.normal(size=(k, D, D)) / 4).astype(np.float32)
    m = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(D, dtype=np.float32)).astype(np.float32)
    return c, m


def rows_near(c, b: int, seed: int):
    """B rows near the bank's centroids; the last two of a batch far from all."""
    rng = np.random.default_rng(seed)
    z = c[rng.integers(0, c.shape[0], size=b)] + 0.05 * rng.normal(size=(b, D))
    if b > 1:
        z[-2:] += 100.0
    return z.astype(np.float32)


def terms_at(lib, z, c, m, geometry, prof=None):
    """B4 at a given (rows, warps, ctas); the profile entry with ``prof``."""
    b, k = z.shape[0], c.shape[0]
    lp = torch.empty((b,), device=z.device)
    grad = torch.empty((b, D), device=z.device)
    rows, warps, ctas = geometry[:3]
    args = (z.data_ptr(), c.data_ptr(), m.data_ptr(), INV_T2, LBD, LOG_EPS, lp.data_ptr(),
            grad.data_ptr(), b, k, rows, warps, ctas)
    if prof is None:
        code = lib.hmc_terms_at_f32(*args, stream_handle(z.device))
    else:
        code = lib.hmc_terms_profile_f32(*args, prof.data_ptr(), stream_handle(z.device))
    if code != 0:
        raise RuntimeError(f"hmc_terms at {geometry}: cudaError_t {code}")
    return lp, grad


def partials_at(lib, z, c, m, geometry, prof=None):
    """B8 at a given (rows, warps, ctas); the profile entry with ``prof``."""
    b, k = z.shape[0], c.shape[0]
    gi = torch.empty((b, D, D), device=z.device)
    v = torch.empty((b, D), device=z.device)
    rows, warps, ctas = geometry[:3]
    args = (z.data_ptr(), c.data_ptr(), m.data_ptr(), INV_T2, gi.data_ptr(), v.data_ptr(), b, k,
            rows, warps, ctas)
    if prof is None:
        code = lib.hmc_partials_at_f32(*args, stream_handle(z.device))
    else:
        code = lib.hmc_partials_profile_f32(*args, prof.data_ptr(), stream_handle(z.device))
    if code != 0:
        raise RuntimeError(f"hmc_partials at {geometry}: cudaError_t {code}")
    return gi, v


def ptxas_lines(log: str, tag: str) -> list:
    """The ``-Xptxas -v`` lines (entry, registers, spills) of the kernels whose
    mangled name contains ``tag``."""
    out, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            inside = tag in ln
        if inside and ("Compiling entry" in ln or "registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def library_geometry(lib, b: int, k: int, sms: int) -> tuple:
    out = (ctypes.c_int * 4)()
    code = lib.hmc_geometry(b, k, sms, out)
    if code != 0:
        raise RuntimeError(f"hmc_geometry({b}, {k}): cudaError_t {code}")
    return tuple(out)


def graph_ms(fn, n: int = GRAPH_LAUNCHES, replays: int = 3):
    """(device ms per launch, outputs): ``fn`` captured ``n`` times into one
    CUDA graph, replayed once to warm up, then ``replays`` times between CUDA
    events.  The outputs are the last captured call's after the timed
    replays."""
    fn()  # warm-up outside the graph (library load, shared-memory opt-in)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            out = fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays), out


def rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def check_terms(got, plain) -> dict:
    lp_err = float((got[0] - plain[0]).abs().max())
    g_err = rel(got[1], plain[1])
    return {"log_pi_abs": lp_err, "grad_rel": g_err, "ok": lp_err <= LP_ATOL and g_err <= GRAD_RTOL}


def check_partials(got, plain) -> dict:
    gi_err = float(((got[0] - plain[0]).abs() / plain[0].abs().clamp_min(1.0)).max())
    v_err = float(((got[1] - plain[1]).abs() / plain[1].abs().clamp_min(1.0)).max())
    return {"gi_part_rel": gi_err, "v_rel": v_err, "ok": gi_err <= GI_RTOL and v_err <= V_RTOL}


def forced_geometries():
    """Every rows per CTA with one CTA and with a cluster of 8, at 8 warps;
    rows 1, 2, 4 also at 16 warps, and at 3 warps with a cluster of 2."""
    out = [(r, 8, c) for r in (1, 2, 4, 8) for c in (1, 8)]
    return out + [(r, 16, 8) for r in (1, 2, 4)] + [(r, 3, 2) for r in (1, 2, 4)]


def sweep_geometries(b: int, k: int):
    rows = (4, 8) if b >= 1000 else (1, 2, 4, 8)
    out = [(r, w, c) for r, w, c in itertools.product(rows, (4, 8, 16), (1, 2, 4, 8))
           if w <= mk.hmc_max_warps(r)]
    if k >= 20_000:  # clusters of 5, 6, 7: fewer CTAs a row group, more groups at once
        out += [(r, w, c) for r, w, c in itertools.product(rows, (8, 16), (5, 6, 7))
                if w <= mk.hmc_max_warps(r)]
    return out



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--deadline-s", type=float, default=600.0,
                    help="dump every thread's stack and exit after this long")
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(args.deadline_s, exit=True)
    if not torch.cuda.is_available():
        print("hmc_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lines = []

    def emit(**rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lib = kernel_library()
    emit(kind="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi, sms=sms,
         build_seconds=lib.seconds, ptxas=ptxas_lines(lib.log, "hmc_"))

    ok = True
    slots = mk.hmc_cluster_slots(dev)
    for b in GEOMETRY_BATCHES:
        for k in GEOMETRY_BANKS:
            rule = tuple(mk.hmc_geometry(b, k, sms, slots))
            same = rule == library_geometry(lib, b, k, sms)
            ok &= same
            emit(kind="geometry", batch=b, k=k, rows=rule[0], warps=rule[1], ctas=rule[2],
                 clusters=rule[3], ctas_total=rule[2] * rule[3],
                 cluster_slots=slots(*rule[:3]), matches_library=same)

    banks = {k: tuple(torch.tensor(x, device=dev) for x in bank(k)) for k in BANKS}
    for b in BATCHES:
        for k in BANKS:
            c, m = banks[k]
            z = torch.tensor(rows_near(c.cpu().numpy(), b, b + k), device=dev)
            plain_t = mk.hmc_terms_ref(z, c, m, INV_T2, LBD, LOG_EPS)
            plain_p = mk.hmc_partials_ref(z, c, m, INV_T2)
            rule = tuple(mk.launch_hmc_geometry(b, k, dev))
            for geometry in [rule[:3]] + forced_geometries():
                t1, t2 = terms_at(lib, z, c, m, geometry), terms_at(lib, z, c, m, geometry)
                p1, p2 = partials_at(lib, z, c, m, geometry), partials_at(lib, z, c, m, geometry)
                torch.cuda.synchronize()
                same = all(map(torch.equal, (*t1, *p1), (*t2, *p2)))
                ct, cp = check_terms(t1, plain_t), check_partials(p1, plain_p)
                far = b == 1 or bool(torch.all(t1[1][-2:] == 0) and torch.all(p1[0][-2:] == 0)
                                     and torch.all(p1[1][-2:] == 0))
                good = ct["ok"] and cp["ok"] and same and far
                ok &= good
                emit(kind="check", batch=b, k=k, geometry=list(geometry),
                     rule=geometry == rule[:3], terms=ct, partials=cp,
                     relaunch_bit_identical=same, far_rows_zero=far, ok=good)

    # where the time goes: clock64 sums per phase of thread 0 of CTA 0 (the
    # profile build), at the rule's geometry, in us at the card's largest SM
    # clock (nvidia-smi), beside the launch's device time (the whole grid)
    plib = kernel_library(profile=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.split()[0])
    for b in BATCHES:
        for k in BANKS:
            c, m = banks[k]
            z = torch.tensor(rows_near(c.cpu().numpy(), b, b + k), device=dev)
            rule = tuple(mk.launch_hmc_geometry(b, k, dev))
            for name, launch in (("hmc_terms", terms_at), ("hmc_partials", partials_at)):
                prof = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
                ms, _ = graph_ms(lambda: launch(plib, z, c, m, rule, prof))
                cycles = prof.tolist()
                emit(kind="profile", kernel=name, batch=b, k=k, geometry=list(rule),
                     launch_device_ms=ms, sm_clock_mhz=clock_mhz, cycles=dict(zip(PHASES, cycles)),
                     us_at_max_clock={p: v / clock_mhz for p, v in zip(PHASES, cycles)})

    if args.sweep and ok:
        for b in BATCHES:
            for k in BANKS:
                c, m = banks[k]
                z = torch.tensor(rows_near(c.cpu().numpy(), b, b + k), device=dev)
                rule = tuple(mk.launch_hmc_geometry(b, k, dev))
                for geometry in sweep_geometries(b, k):
                    t_ms, _ = graph_ms(lambda: terms_at(lib, z, c, m, geometry))
                    p_ms, _ = graph_ms(lambda: partials_at(lib, z, c, m, geometry))
                    clusters = -(-b // geometry[0])
                    emit(kind="time", batch=b, k=k, geometry=list(geometry), clusters=clusters,
                         cluster_slots=slots(*geometry),
                         rule=geometry == rule[:3], terms_ms=t_ms, partials_ms=p_ms)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        with open(args.out / "hmc_sweep.jsonl", "w") as fh:
            fh.writelines(json.dumps(rec) + "\n" for rec in lines)
    emit(kind="result", ok=ok)
    faulthandler.cancel_dump_traceback_later()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
