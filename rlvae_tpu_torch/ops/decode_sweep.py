"""The decode+MSE kernels (B5: forward, dh, dW/db) on one card: checks, cold
and warm times, a phase profile and a sweep of their geometry.

    python -m rlvae_tpu_torch.ops.decode_sweep [--sweep] [--out DIR]

Builds the kernels and prints the ``-Xptxas -v`` lines of the decode+MSE
kernels and the rule's geometry (``recon_kernels.decode_geometry`` with the
card's cluster slots) at M = 32, 128, 512, 4096 (B = 4, 16, 64, 512 frames
of 8) for N = 12288, K = 512.  Each entry point is then held to its plain
PyTorch version and the loss also to fp64 (the tolerances of
``chip_smoke.py``) at those M and at shapes that cross the tiling (M = 1,
37, 129, 1000; K = 1, 16, 64, 500; a ragged N), at the rule's geometry and
at forced ones (every dh cluster size, forward row groups), relaunched and
replayed in a CUDA graph for bit-identity.  Times at N = 12288, K = 512 and
each M: device time per launch (a CUDA graph of ``GRAPH_LAUNCHES``
launches, replayed), the cold time (each launch after a 256 MB write that
evicts the 50 MB L2, that write's own time subtracted), the plain
version's and cuBLAS's bf16 product alone for each entry point's second
product, beside the bound (bytes of the inputs and outputs over 3.35 TB/s;
products over 989 TFLOP/s).  The profile build (``-DDECODE_PROFILE``)
then sums clock64 laps per phase (W staging, h waits, the pre-activation
product, the epilogue, the second product, dh's wait for its cluster and
its rank-ordered sum, the stores) on
thread 0 of CTA 0 at M = 128 and 512.  With ``--sweep`` it also times every
dh cluster size and forward row-group count at each M.  One JSON line per
result; ``--out`` also writes them to ``DIR/decode_sweep.jsonl``.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from rlvae_tpu_torch.ops import recon_kernels as rk
from rlvae_tpu_torch.ops._launch import stream_handle
from rlvae_tpu_torch.ops.build import kernel_library

N, K = 12288, 512
TIMED_ROWS = (32, 128, 512, 4096)
# (M, N, K) that cross the tiling: one row, ragged tiles, K not a multiple
# of 8 or of 64, fewer columns than one CTA holds
EDGE_SHAPES = ((1, 1, 1), (1, 12288, 512), (37, 300, 64), (129, 12290, 500), (1000, 777, 16),
               (128, 12288, 1), (512, 1000, 512))
GRAPH_LAUNCHES = 20
FLUSH_BYTES = 256 << 20
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12
# chip_smoke.py: DECODE_LOSS_RTOL, DECODE_GRAD_RTOL, DECODE_FP64_FACTOR, DECODE_FP64_RTOL
LOSS_RTOL, GRAD_RTOL, FP64_FACTOR, FP64_RTOL = 1e-5, 1e-3, 2.0, 1e-6
# the phases of the profile build (csrc/decode_mse.cu Phase)
PHASES = ("w_stage", "h_wait", "pre", "epilogue", "product2", "cluster_wait", "cluster_sum",
          "store", "total")


def problem(dev, m: int, n: int, k: int, seed: int = 0):
    """Decoder-like inputs (tests/test_torch_kernels.py ``_decode_problem``):
    h post-ReLU bf16, W and b at a Linear init's scale, x in [0, 1], rw 1/16
    with rows 3 and 4 at 0."""
    rng = np.random.default_rng(seed + m + n + k)
    h = np.maximum(rng.normal(size=(m, k)), 0.0)
    w = rng.uniform(-1, 1, size=(n, k)) / np.sqrt(k)
    b = rng.uniform(-1, 1, size=(n,)) / np.sqrt(k)
    x = rng.uniform(size=(m, n))
    rw = np.full((m,), 1.0 / 16)
    rw[3:5] = 0.0
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return t(h).to(torch.bfloat16), t(w), t(b), t(x), t(rw)


def ptxas_lines(log: str, tag: str = "6decode") -> list:
    out, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            inside = tag in ln
        if inside and ("Compiling entry" in ln or "registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def graph_ms(fn, n: int = GRAPH_LAUNCHES, replays: int = 3, before=None):
    """(device ms per launch, outputs): ``fn`` (after ``before``, if given)
    captured ``n`` times into one CUDA graph, replayed once, then
    ``replays`` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            if before is not None:
                before()
            out = fn() if fn is not None else None
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays), out


def cold_ms(fn, flush: torch.Tensor) -> dict:
    """Device ms per launch with the L2 evicted before each: a graph of
    (write ``flush``, ``fn``) pairs less a graph of the writes alone."""
    write = lambda: flush.fill_(1.0)  # noqa: E731
    both, _ = graph_ms(fn, before=write)
    alone, _ = graph_ms(lambda: None, before=write)
    return {"cold_ms": both - alone, "flush_ms": alone, "flush_bytes": flush.numel() * 4}


def entry_bytes(name: str, m: int, n: int, k: int) -> float:
    """Bytes each entry point must move: its inputs read once (h bf16; W, b,
    x, rw fp32), its outputs written once."""
    ins = m * k * 2 + n * k * 4 + n * 4 + m * n * 4 + m * 4
    out = {"fwd": 4, "dh": m * k * 2, "dw": n * k * 4 + n * 4}[name]
    return ins + out


def bound_ms(name: str, m: int, n: int, k: int) -> dict:
    products = {"fwd": 1, "dh": 2, "dw": 2}[name]
    t_bytes = entry_bytes(name, m, n, k) / PEAK_BYTES_PER_S
    t_ops = products * 2.0 * m * n * k / PEAK_BF16_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def run(lib, name: str, args, geo: rk.DecodeGeometry, prof=None):
    """One entry point at a given geometry; returns its outputs."""
    h, w, b, x, rw = args
    m, k = h.shape
    n = w.shape[0]
    g = torch.ones((), device=x.device)
    ptrs = [t.data_ptr() for t in (h, w, b, x, rw)]
    stream = stream_handle(x.device)
    tail = () if prof is None else (prof.data_ptr(),)
    sfx = "_f32" if prof is None else "_profile_f32"
    if name == "fwd":
        partials = torch.empty(geo.fwd_ctas * geo.fwd_row_groups, device=x.device)
        loss = torch.empty((), device=x.device)
        code = getattr(lib, "decode_mse_fwd" + sfx)(
            *ptrs, partials.data_ptr(), loss.data_ptr(), m, k, n, geo.fwd_ctas,
            geo.fwd_row_groups, *tail, stream)
        out = (loss,)
    elif name == "dh":
        ws = torch.empty((geo.dh_clusters, m, k), device=x.device)
        dh = torch.empty((m, k), device=x.device)
        code = getattr(lib, "decode_mse_bwd_dh" + sfx)(
            *ptrs, g.data_ptr(), ws.data_ptr(), dh.data_ptr(), m, k, n, geo.dh_cluster,
            geo.dh_clusters, geo.dh_row_groups, 1, *tail, stream)
        out = (dh.to(torch.bfloat16),)
    else:
        dw = torch.empty((n, k), device=x.device)
        db = torch.empty((n,), device=x.device)
        code = getattr(lib, "decode_mse_bwd_dw" + sfx)(
            *ptrs, g.data_ptr(), dw.data_ptr(), db.data_ptr(), m, k, n, geo.dw_ctas, *tail,
            stream)
        out = (dw, db)
    if code != 0:
        raise RuntimeError(f"decode_mse {name} at {tuple(geo)}: cudaError_t {code}")
    return out


def check(args, outs: dict) -> dict:
    """Each entry point's outputs against the plain versions (and the loss
    against fp64), at chip_smoke.py's tolerances."""
    h, w, b, x, rw = args
    g = torch.ones((), device=x.device)
    res = {}
    loss = float(outs["fwd"][0])
    ref = float(rk.decode_mse_ref(*args))
    ref64 = float(rk.decode_mse_ref(h, w.double(), b.double(), x.double(), rw.double()))
    err_k, err_p = abs(loss - ref64), abs(ref - ref64)
    res["fwd"] = {"abs_err": abs(loss - ref), "kernel_vs_fp64": err_k, "plain_vs_fp64": err_p,
                  "ok": abs(loss - ref) <= LOSS_RTOL * abs(ref) + 1e-30
                  and err_k <= max(FP64_FACTOR * err_p, FP64_RTOL * abs(ref64))}
    dh, dh_p = outs["dh"][0].float(), rk.decode_mse_dh_ref(*args, g).float()
    scale = float(dh_p.abs().max())
    d = (dh - dh_p).abs()
    masked = h.shape[0] <= 4 or bool(torch.all(dh[3:5] == 0))
    res["dh"] = {"abs_err": float(d.max()), "scale": scale, "masked_rows_zero": masked,
                 "ok": bool(torch.all(d <= 2.0 ** -7 * dh_p.abs() + GRAD_RTOL * scale))
                 and masked}
    dw_p, db_p = rk.decode_mse_dw_ref(*args, g)
    errs = {}
    for label, got, want in (("dw", outs["dw"][0], dw_p), ("db", outs["dw"][1], db_p)):
        err, sc = float((got - want).abs().max()), float(want.abs().max())
        errs[label] = {"abs_err": err, "scale": sc, "ok": err <= GRAD_RTOL * sc}
    res["dw"] = {**errs, "abs_err": max(errs["dw"]["abs_err"], errs["db"]["abs_err"]),
                 "ok": errs["dw"]["ok"] and errs["db"]["ok"]}
    return res


def replays_bit_identical(lib, name, args, geo, first) -> dict:
    """A second launch and a CUDA-graph replay give ``first``'s bits."""
    again = run(lib, name, args, geo)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        captured = run(lib, name, args, geo)
    graph.replay()
    torch.cuda.synchronize()
    return {"relaunch": all(map(torch.equal, first, again)),
            "graph_replay": all(map(torch.equal, first, captured))}


def forced_geometries(m: int, n: int, k: int, rule: rk.DecodeGeometry):
    """Every dh cluster size with the fewest clusters that cover N, a dh
    split into more clusters than needed, and forward row groups 1 and 3."""
    need = -(-(-(-n // 8)) // rk.DH_BLOCKS)
    out = [rule._replace(dh_cluster=c, dh_clusters=-(-need // c), dh_row_groups=1)
           for c in range(1, rk.MAX_CLUSTER + 1)]
    out.append(rule._replace(dh_cluster=2, dh_clusters=-(-need // 2) + 1, dh_row_groups=2,
                             fwd_row_groups=3, fwd_ctas=rule.fwd_ctas + 1,
                             dw_ctas=rule.dw_ctas + 1))
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
        print("decode_sweep: needs a CUDA card", file=sys.stderr)
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
    slots = rk.dh_cluster_slots(dev)
    emit(kind="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi, sms=sms,
         build_seconds=lib.seconds, ptxas=ptxas_lines(lib.log),
         dh_cluster_slots={c: slots(K, c) for c in range(1, rk.MAX_CLUSTER + 1)})
    for m in TIMED_ROWS:
        geo = rk.launch_decode_geometry(m, N, K, dev)
        emit(kind="geometry", m=m, n=N, k=K, **geo._asdict(),
             dh_workspace_bytes=(geo.dh_clusters * m * K * 4 if geo.dh_clusters > 1 else 0))

    ok = True
    names = ("fwd", "dh", "dw")
    shapes = [(m, N, K) for m in TIMED_ROWS] + list(EDGE_SHAPES)
    for m, n, k in shapes:
        a = problem(dev, m, n, k)
        rule = rk.launch_decode_geometry(m, n, k, dev)
        geos = [rule] + (forced_geometries(m, n, k, rule) if m <= 512 else [])
        for geo in geos:
            outs = {name: run(lib, name, a, geo) for name in names}
            torch.cuda.synchronize()
            res = check(a, outs)
            same = {name: replays_bit_identical(lib, name, a, geo, outs[name]) for name in names}
            good = all(r["ok"] for r in res.values()) and all(
                all(s.values()) for s in same.values())
            ok &= good
            emit(kind="check", m=m, n=n, k=k, geometry=list(geo), rule=geo == rule,
                 **{name: {**res[name], **same[name]} for name in names}, ok=good)
        del a
        torch.cuda.empty_cache()

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    g = torch.ones((), device=dev)
    for m in TIMED_ROWS:
        a = problem(dev, m, N, K)
        h, w, b, x, rw = a
        geo = rk.launch_decode_geometry(m, N, K, dev)
        w16 = w.to(torch.bfloat16)
        dp16 = rk._dp(h, w, b, x, rw, torch.float32).to(torch.bfloat16)
        products = {"fwd": lambda: torch.matmul(h, w16.t()),
                    "dh": lambda: torch.matmul(dp16, w16),
                    "dw": lambda: torch.matmul(dp16.t(), h)}
        plains = {"fwd": lambda: rk.decode_mse_ref(*a), "dh": lambda: rk.decode_mse_dh_ref(*a, g),
                  "dw": lambda: rk.decode_mse_dw_ref(*a, g)}
        for name in names:
            kern = lambda: run(lib, name, a, geo)  # noqa: E731
            dev_ms, _ = graph_ms(kern)
            rec = {"device_ms": dev_ms, **cold_ms(kern, flush),
                   "plain_device_ms": graph_ms(plains[name], n=5)[0],
                   "cublas_bf16_product_ms": graph_ms(products[name])[0],
                   **bound_ms(name, m, N, K)}
            emit(kind="time", entry=name, m=m, n=N, k=K, geometry=list(geo), **rec)
        del a, dp16, w16
        torch.cuda.empty_cache()

    # where the time goes: clock64 sums per phase of thread 0 of CTA 0 (the
    # profile build), in us at the card's largest SM clock
    plib = kernel_library(profile=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.split()[0])
    for m in (128, 512):
        a = problem(dev, m, N, K)
        geo = rk.launch_decode_geometry(m, N, K, dev)
        for name in names:
            prof = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
            ms, _ = graph_ms(lambda: run(plib, name, a, geo, prof))
            cycles = prof.tolist()
            emit(kind="profile", entry=name, m=m, geometry=list(geo), launch_device_ms=ms,
                 sm_clock_mhz=clock_mhz, cycles=dict(zip(PHASES, cycles)),
                 us_at_max_clock={p: v / clock_mhz for p, v in zip(PHASES, cycles)})

    if args.sweep and ok:
        for m in TIMED_ROWS:
            a = problem(dev, m, N, K)
            rule = rk.launch_decode_geometry(m, N, K, dev)
            need = -(-(N // 8) // rk.DH_BLOCKS)
            for c in range(1, rk.MAX_CLUSTER + 1):
                geo = rule._replace(dh_cluster=c, dh_clusters=-(-need // c), dh_row_groups=1)
                ms, _ = graph_ms(lambda: run(lib, "dh", a, geo))
                emit(kind="sweep", entry="dh", m=m, geometry=list(geo), rule=geo == rule,
                     cluster_slots=slots(K, c), device_ms=ms)
            for groups in (1, 2, 4):
                geo = rule._replace(fwd_row_groups=groups)
                ms, _ = graph_ms(lambda: run(lib, "fwd", a, geo))
                emit(kind="sweep", entry="fwd", m=m, geometry=list(geo), rule=geo == rule,
                     device_ms=ms)
            del a
            torch.cuda.empty_cache()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        with open(args.out / "decode_sweep.jsonl", "w") as fh:
            fh.writelines(json.dumps(rec) + "\n" for rec in lines)
    emit(kind="result", ok=ok)
    faulthandler.cancel_dump_traceback_later()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
