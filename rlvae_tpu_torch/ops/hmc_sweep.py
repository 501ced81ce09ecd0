"""The kernels of ``csrc/hmc_bank.cuh``'s front half on one card: checks,
warm and cold times, a phase profile and a sweep of their geometry.

    python -m rlvae_tpu_torch.ops.hmc_sweep [--kernel K ...] [--sweep] [--out DIR]
    python -m rlvae_tpu_torch.ops.hmc_sweep --dump PATH

``--kernel`` picks ``hmc`` (the default: the manifold-HMC kernels B4
``hmc_terms`` and B8 ``hmc_partials``), ``chol_bundle`` (B1),
``metric_bundle`` (B6) or ``g_inv`` (B7), one or several.  ``--dim D``
(default 16, any 1..32) sets the latent width of every bank and row: D > 16
runs the kernels' width-32 instances, D not 16 or 32 a zero-padded bank.

For ``hmc``: builds the kernels and prints the ``-Xptxas -v`` lines of the
HMC kernels, then the rule's geometry (``metric_kernels.hmc_geometry``, held to the
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
host issue time inside).

For each metric kernel (``chol_bundle``, ``metric_bundle``, ``g_inv``): its
``-Xptxas -v`` lines; the card's cluster slots of its instance of the rule;
the rule's geometry (``hmc_geometry(..., kernel)``, held to the library's)
at B = 1, 16, 37, 64, 1000 and the banks above; the kernel held to its
plain version and to fp64 (``chip_smoke.py``'s tolerances; L zero above the
diagonal, G bitwise symmetric, far rows G^{-1} = lbd I exactly, G^{-1}
alone bitwise equal to the bundle's at the same geometry) at B = 1, 16, 64,
1000 and K = 50, 200, 20 000, at the rule's geometry and at forced ones,
relaunched for bit-identity; warm device time per launch (as above) and
cold (each launch after a 256 MB write that evicts the 50 MB L2, the
write's own time subtracted) at the rule's geometry; the profile build's
phases, with the epilogue split into the Cholesky, the inverse X = L^{-1}
and G = X^T X; and with ``--sweep`` every geometry's time.

``--dump PATH`` only writes every kernel's outputs (B4, B8, B1, B6, B7) on
the seeded inputs at B = 1 and 64 and K = 50 and 20 000 to PATH
(``torch.save``), to compare two builds bit for bit; ``--time-wrappers`` only times the public wrappers of B1, B6
and B7 (warm and cold device ms per call, as above, and the CUDA-event ms
of back-to-back calls, host issue included) at B = 16 and 64 and K = 50,
200 and 20 000.  Both use nothing but the wrappers, so they also run
against an older checkout of the package, run as
``PYTHONPATH=OLD python path/to/hmc_sweep.py ...``.

One JSON line per result; ``--out`` also writes them to
``DIR/hmc_sweep.jsonl``.  Needs a CUDA card.
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

D = 16  # the latent width (--dim)
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
          "cluster_reduce", "cholesky", "inverse", "gram", "finish", "total")
# the metric kernels (chip_smoke.py's tolerances): chol-bundle |k - p| <=
# CHOL_ATOL + CHOL_RTOL |p|; the bundle's (rtol, atol) per output (G^{-1},
# L, logdet, G), G^{-1} alone as the bundle's G^{-1}; against fp64 each
# output's error at most FP64_FACTOR times the plain fp32 version's, or
# FP64_RTOL of its scale
METRIC_KERNELS = ("chol_bundle", "metric_bundle", "g_inv")
JITTER = 1e-6  # the chol-bundle's diag is lbd + jitter, as chol_g_inv's
CHOL_RTOL, CHOL_ATOL = 1e-4, 1e-5
BUNDLE_TOL = ((1e-5, 1e-6), (1e-4, 1e-4), (1e-4, 1e-4), (1e-3, 1e-3))
FP64_FACTOR, FP64_RTOL = 2.0, 1e-5
METRIC_GEOMETRY_BATCHES = (1, 16, 37, 64, 1000)
METRIC_BATCHES = (1, 16, 64, 1000)
FLUSH_BYTES = 256 << 20


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
    c, m = mk.pad_bank(c, m, mk.bank_width(D))
    args = (z.data_ptr(), c.data_ptr(), m.data_ptr(), INV_T2, LBD, LOG_EPS, lp.data_ptr(),
            grad.data_ptr(), b, k, D, rows, warps, ctas)
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
    c, m = mk.pad_bank(c, m, mk.bank_width(D))
    args = (z.data_ptr(), c.data_ptr(), m.data_ptr(), INV_T2, gi.data_ptr(), v.data_ptr(), b, k,
            D, rows, warps, ctas)
    if prof is None:
        code = lib.hmc_partials_at_f32(*args, stream_handle(z.device))
    else:
        code = lib.hmc_partials_profile_f32(*args, prof.data_ptr(), stream_handle(z.device))
    if code != 0:
        raise RuntimeError(f"hmc_partials at {geometry}: cudaError_t {code}")
    return gi, v


def metric_at(lib, name: str, z, c, m, geometry, prof=None):
    """B1, B6 or B7 at a given (rows, warps, ctas): (L, logdet), (G^{-1}, L,
    logdet, G) or (G^{-1},); the profile entry with ``prof``."""
    b, k = z.shape[0], c.shape[0]
    mat = lambda: torch.empty((b, D, D), device=z.device)  # noqa: E731
    if name == "chol_bundle":
        outs, scalars = (mat(), torch.empty((b,), device=z.device)), (INV_T2, LBD + JITTER)
    elif name == "metric_bundle":
        outs, scalars = (mat(), mat(), torch.empty((b,), device=z.device), mat()), (INV_T2, LBD)
    else:
        outs, scalars = (mat(),), (INV_T2, LBD)
    c, m = mk.pad_bank(c, m, mk.bank_width(D))
    args = (z.data_ptr(), c.data_ptr(), m.data_ptr(), *scalars, *(o.data_ptr() for o in outs),
            b, k, D, *geometry[:3])
    if prof is None:
        code = getattr(lib, f"{name}_at_f32")(*args, stream_handle(z.device))
    else:
        code = getattr(lib, f"{name}_profile_f32")(*args, prof.data_ptr(), stream_handle(z.device))
    if code != 0:
        raise RuntimeError(f"{name} at {geometry}: cudaError_t {code}")
    return outs


def metric_call(name: str):
    """The wrapper of a metric kernel on the sweep's scalars: (z, c, m) -> outputs."""
    if name == "chol_bundle":
        return lambda z, c, m: mk.chol_bundle(z, c, m, INV_T2, LBD + JITTER)
    if name == "metric_bundle":
        return lambda z, c, m: mk.metric_bundle(z, c, m, INV_T2, LBD)
    return lambda z, c, m: (mk.g_inv(z, c, m, INV_T2, LBD),)


def metric_plain(name: str, z, c, m):
    """The plain version of a metric kernel, as a tuple of its outputs."""
    if name == "chol_bundle":
        return mk.chol_bundle_ref(z, c, m, INV_T2, LBD + JITTER)
    if name == "metric_bundle":
        return mk.metric_bundle_ref(z, c, m, INV_T2, LBD)
    return (mk.g_inv_ref(z, c, m, INV_T2, LBD),)


def check_metric(name: str, got, plain, want) -> dict:
    """``got`` against the plain fp32 outputs and the fp64 ones."""
    tols = {"chol_bundle": ((CHOL_RTOL, CHOL_ATOL),) * 2, "metric_bundle": BUNDLE_TOL,
            "g_inv": BUNDLE_TOL[:1]}[name]
    out, ok = {}, True
    for i, (k_out, p_out, e_out, (rtol, atol)) in enumerate(zip(got, plain, want, tols)):
        ke = float((k_out.double() - e_out).abs().max())
        pe = float((p_out.double() - e_out).abs().max())
        scale = float(e_out.abs().max())
        good = (bool(torch.all((k_out - p_out).abs() <= atol + rtol * p_out.abs()))
                and ke <= max(FP64_FACTOR * pe, FP64_RTOL * scale))
        out[f"out{i}"] = {"kernel_vs_plain_abs": float((k_out - p_out).abs().max()),
                          "kernel_vs_fp64_abs": ke, "plain_vs_fp64_abs": pe, "ok": good}
        ok = ok and good
    if name != "g_inv":
        l = got[0] if name == "chol_bundle" else got[1]
        ok = ok and bool(torch.all(torch.triu(l, 1) == 0))
    if name == "metric_bundle":
        ok = ok and bool(torch.equal(got[3], got[3].transpose(-1, -2)))
    if name != "chol_bundle" and got[0].shape[0] > 1:  # the far rows: G^{-1} = lbd I exactly
        eye = LBD * torch.eye(D, device=got[0].device)
        ok = ok and bool(torch.equal(got[0][-2:], eye.expand(2, D, D)))
    out["ok"] = ok
    return out


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


def library_geometry(lib, b: int, k: int, sms: int, kernel: str = "hmc_terms") -> tuple:
    out = (ctypes.c_int * 4)()
    code = lib.hmc_geometry(b, k, sms, mk.BANK_KERNELS[kernel], mk.bank_width(D), out)
    if code != 0:
        raise RuntimeError(f"hmc_geometry({b}, {k}, {kernel}): cudaError_t {code}")
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


def cold_ms(fn, flush: torch.Tensor) -> float:
    """Device ms per launch of ``fn`` with the L2 evicted before each: a graph
    of (write ``flush``, ``fn``) pairs less a graph of the writes alone."""
    write = lambda: flush.fill_(1.0)  # noqa: E731

    def pair():
        write()
        return fn()

    return graph_ms(pair)[0] - graph_ms(write)[0]


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


def _fits(geometry, kernel: str) -> bool:
    """True when the kernels of width D launch at (rows, warps, ctas)."""
    r, w, _ = geometry
    return r <= mk.HMC_LAYOUTS[mk.bank_width(D)][1] and w <= mk.hmc_max_warps(r, kernel, D)


def forced_geometries(kernel: str = "hmc_terms"):
    """Every rows per CTA with one CTA and with a cluster of 8, at 8 warps;
    rows 1, 2, 4 also at 16 warps, and at 3 warps with a cluster of 2; for
    the metric kernels also 8 rows at 16 warps, one warp alone, a warp for
    several rows in clusters of 2, 7 and 8; those the width D launches."""
    out = [(r, 8, c) for r in (1, 2, 4, 8) for c in (1, 8)]
    out += [(r, 16, 8) for r in (1, 2, 4)] + [(r, 3, 2) for r in (1, 2, 4)]
    if kernel in METRIC_KERNELS:
        out += [(8, 16, 8), (1, 1, 1), (4, 1, 2), (2, 1, 7), (8, 5, 8)]
    return [g for g in out if _fits(g, kernel)]


def sweep_geometries(b: int, k: int, kernel: str = "hmc_terms"):
    rows = (4, 8) if b >= 1000 else (1, 2, 4, 8)
    out = [(r, w, c) for r, w, c in itertools.product(rows, (4, 8, 16), (1, 2, 4, 8))]
    if k >= 20_000:  # clusters of 5, 6, 7: fewer CTAs a row group, more groups at once
        out += [(r, w, c) for r, w, c in itertools.product(rows, (8, 16), (5, 6, 7))]
    return [g for g in out if _fits(g, kernel)]


def dump_hmc(path: Path) -> int:
    """B4's, B8's, B1's, B6's and B7's outputs on the seeded inputs at B = 1
    and 64, K = 50 and 20 000, to ``path``."""
    dev = torch.device("cuda")
    out = {}
    for k in (50, 20_000):
        c, m = (torch.tensor(x, device=dev) for x in bank(k))
        for b in (1, 64):
            z = torch.tensor(rows_near(c.cpu().numpy(), b, b + k), device=dev)
            out[f"hmc_terms_k{k}_b{b}"] = [
                t.cpu() for t in mk.hmc_terms(z, c, m, INV_T2, LBD, LOG_EPS)]
            out[f"hmc_partials_k{k}_b{b}"] = [t.cpu() for t in mk.hmc_partials(z, c, m, INV_T2)]
            for name in METRIC_KERNELS:
                out[f"{name}_k{k}_b{b}"] = [t.cpu() for t in metric_call(name)(z, c, m)]
    torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)
    print(json.dumps({"kind": "dump", "path": str(path), "keys": sorted(out)}), flush=True)
    return 0


def events_ms(fn, iters: int = GRAPH_LAUNCHES) -> float:
    """ms per call from CUDA events around ``iters`` back-to-back calls after
    two warm-up calls: the host's issue time wherever it exceeds the
    kernel's."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_wrappers() -> int:
    """Warm and cold device ms per call of the public B1, B6 and B7 wrappers
    at B = 16 and 64, K = 50, 200 and 20 000, beside the CUDA-event ms of
    back-to-back calls."""
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    for k in BANKS:
        c, m = (torch.tensor(x, device=dev) for x in bank(k))
        for b in (16, 64):
            z = torch.tensor(rows_near(c.cpu().numpy(), b, b + k), device=dev)
            for name in METRIC_KERNELS:
                call = metric_call(name)
                warm, _ = graph_ms(lambda: call(z, c, m))
                print(json.dumps({"kind": "wrapper_time", "kernel": name, "batch": b, "k": k,
                                  "device_ms": warm, "events_ms": events_ms(lambda: call(z, c, m)),
                                  "cold_ms": cold_ms(lambda: call(z, c, m), flush),
                                  "package": str(Path(mk.__file__).parents[2]),
                                  "nvidia_smi": smi}), flush=True)
    return 0


def run_hmc(args, lib, dev, sms: int, emit) -> bool:
    """B4 and B8: geometry, checks, profile and (``--sweep``) times."""
    ok = True
    slots = mk.hmc_cluster_slots(dev, d=D)
    for b in GEOMETRY_BATCHES:
        for k in GEOMETRY_BANKS:
            rule = tuple(mk.hmc_geometry(b, k, sms, slots, d=D))
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
            rule = tuple(mk.launch_hmc_geometry(b, k, dev, d=D))
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
    clock_mhz = max_sm_clock_mhz()
    for b in BATCHES:
        for k in BANKS:
            c, m = banks[k]
            z = torch.tensor(rows_near(c.cpu().numpy(), b, b + k), device=dev)
            rule = tuple(mk.launch_hmc_geometry(b, k, dev, d=D))
            for name, launch in (("hmc_terms", terms_at), ("hmc_partials", partials_at)):
                prof = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
                ms, _ = graph_ms(lambda: launch(plib, z, c, m, rule, prof))
                emit(kind="profile", kernel=name, batch=b, k=k, geometry=list(rule),
                     launch_device_ms=ms, **phase_record(prof, clock_mhz))

    if args.sweep and ok:
        for b in BATCHES:
            for k in BANKS:
                c, m = banks[k]
                z = torch.tensor(rows_near(c.cpu().numpy(), b, b + k), device=dev)
                rule = tuple(mk.launch_hmc_geometry(b, k, dev, d=D))
                for geometry in sweep_geometries(b, k):
                    t_ms, _ = graph_ms(lambda: terms_at(lib, z, c, m, geometry))
                    p_ms, _ = graph_ms(lambda: partials_at(lib, z, c, m, geometry))
                    clusters = -(-b // geometry[0])
                    emit(kind="time", batch=b, k=k, geometry=list(geometry), clusters=clusters,
                         cluster_slots=slots(*geometry),
                         rule=geometry == rule[:3], terms_ms=t_ms, partials_ms=p_ms)
    return ok


def run_metric(name: str, args, lib, dev, sms: int, emit) -> bool:
    """B1, B6 or B7: slots, geometry, checks, warm and cold times, profile and
    (``--sweep``) every geometry's time."""
    ok = True
    slots = mk.hmc_cluster_slots(dev, name, D)
    emit(kind="slots", kernel=name, slots={f"rows={r},warps={w},ctas={c}": slots(r, w, c)
                                           for r in (1, 8) for w in (8, 16)
                                           for c in range(1, mk.HMC_MAX_CTAS + 1)
                                           if _fits((r, w, c), name)})
    for b in METRIC_GEOMETRY_BATCHES:
        for k in GEOMETRY_BANKS:
            rule = tuple(mk.hmc_geometry(b, k, sms, slots, name, D))
            same = rule == library_geometry(lib, b, k, sms, name)
            ok &= same
            emit(kind="geometry", kernel=name, batch=b, k=k, rows=rule[0], warps=rule[1],
                 ctas=rule[2], clusters=rule[3], cluster_slots=slots(*rule[:3]),
                 matches_library=same)

    call = metric_call(name)
    banks = {k: tuple(torch.tensor(x, device=dev) for x in bank(k)) for k in BANKS}
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    for b in METRIC_BATCHES:
        for k in BANKS:
            c, m = banks[k]
            z = torch.tensor(rows_near(c.cpu().numpy(), b, b + k), device=dev)
            plain = metric_plain(name, z, c, m)
            want = metric_plain(name, z.double(), c.double(), m.double())
            rule = tuple(mk.launch_hmc_geometry(b, k, dev, name, D))
            for geometry in [rule[:3]] + forced_geometries(name):
                got, again = (metric_at(lib, name, z, c, m, geometry) for _ in range(2))
                same = all(map(torch.equal, got, again))
                if name == "g_inv":  # the bundle's G^{-1} at the same geometry
                    same = same and torch.equal(
                        got[0], metric_at(lib, "metric_bundle", z, c, m, geometry)[0])
                torch.cuda.synchronize()
                chk = check_metric(name, got, plain, want)
                good = chk["ok"] and same
                ok &= good
                emit(kind="check", kernel=name, batch=b, k=k, geometry=list(geometry),
                     rule=geometry == rule[:3], errors=chk, relaunch_bit_identical=same, ok=good)
            eager = call(z, c, m)
            warm, replayed = graph_ms(lambda: call(z, c, m))
            replay_same = bool(all(map(torch.equal, replayed, eager)))
            ok &= replay_same
            emit(kind="time", kernel=name, batch=b, k=k, geometry=list(rule), device_ms=warm,
                 cold_ms=cold_ms(lambda: call(z, c, m), flush),
                 graph_replay_bit_identical=replay_same)

    plib = kernel_library(profile=True)
    clock_mhz = max_sm_clock_mhz()
    for b in METRIC_BATCHES:
        for k in BANKS:
            c, m = banks[k]
            z = torch.tensor(rows_near(c.cpu().numpy(), b, b + k), device=dev)
            rule = tuple(mk.launch_hmc_geometry(b, k, dev, name, D))
            prof = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
            ms, _ = graph_ms(lambda: metric_at(plib, name, z, c, m, rule, prof))
            emit(kind="profile", kernel=name, batch=b, k=k, geometry=list(rule),
                 launch_device_ms=ms, **phase_record(prof, clock_mhz))

    if args.sweep and ok:
        for b in METRIC_BATCHES:
            for k in BANKS:
                c, m = banks[k]
                z = torch.tensor(rows_near(c.cpu().numpy(), b, b + k), device=dev)
                rule = tuple(mk.launch_hmc_geometry(b, k, dev, name, D))
                for geometry in sweep_geometries(b, k, name):
                    t_ms, _ = graph_ms(lambda: metric_at(lib, name, z, c, m, geometry))
                    emit(kind="time", kernel=name, batch=b, k=k, geometry=list(geometry),
                         clusters=-(-b // geometry[0]), cluster_slots=slots(*geometry),
                         rule=geometry == rule[:3], device_ms=t_ms)
    return ok


def max_sm_clock_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.split()[0])


def phase_record(prof: torch.Tensor, clock_mhz: float) -> dict:
    cycles = prof.tolist()
    return {"sm_clock_mhz": clock_mhz, "cycles": dict(zip(PHASES, cycles)),
            "us_at_max_clock": {p: v / clock_mhz for p, v in zip(PHASES, cycles)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", nargs="+", default=["hmc"], choices=("hmc", *METRIC_KERNELS))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--dim", type=int, default=16, help="latent width, 1..32")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--dump", type=Path, default=None)
    ap.add_argument("--time-wrappers", action="store_true")
    ap.add_argument("--deadline-s", type=float, default=600.0,
                    help="dump every thread's stack and exit after this long")
    args = ap.parse_args(argv)
    global D
    D = args.dim
    faulthandler.dump_traceback_later(args.deadline_s, exit=True)
    if not torch.cuda.is_available():
        print("hmc_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.dump is not None:
        return dump_hmc(args.dump)
    if args.time_wrappers:
        return time_wrappers()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lines = []

    def emit(**rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lib = kernel_library()
    tags = {"hmc": "hmc_", "chol_bundle": "chol_bundle", "metric_bundle": "metric_bundle",
            "g_inv": "metric_bundle"}
    emit(kind="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi, sms=sms, dim=D,
         build_seconds=lib.seconds,
         ptxas={kernel: ptxas_lines(lib.log, tags[kernel]) for kernel in args.kernel})

    ok = True
    for kernel in args.kernel:
        if kernel == "hmc":
            ok &= run_hmc(args, lib, dev, sms, emit)
        else:
            ok &= run_metric(kernel, args, lib, dev, sms, emit)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        with open(args.out / "hmc_sweep.jsonl", "w") as fh:
            fh.writelines(json.dumps(rec) + "\n" for rec in lines)
    emit(kind="result", ok=ok)
    faulthandler.cancel_dump_traceback_later()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
