"""Smoke run of the PyTorch/CUDA port (rlvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:

1. ``device``: the card's name, count, and ``nvidia-smi`` name and power limit.
2. ``build``: one ``nvcc`` call builds every ``rlvae_tpu_torch/csrc/*.cu``.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the shapes the serving path gives it, with the tolerance stated; ms
   per launch from CUDA events.
4. ``serve``: ``ModelManager.from_config(PRESETS["riemannian_flow_vae"])`` on
   the card behind a ``BatchingEngine``; 64 ``reconstruct`` requests from 8
   threads plus 16 ``encode`` and 16 ``decode``, after one warm-up call per
   (op, bucket).  Both kernels' launch counters are zeroed just before the
   requests and read just after; one B=64 forward on the card is held
   against the same model moved to the CPU, and one is profiled.

Then a ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
run exits non-zero; a hang dumps every thread's stack after 240 s and exits.
Without a CUDA card the run fails at once.
"""

from __future__ import annotations

import copy
import faulthandler
import json
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

PRETRAINED = Path(__file__).resolve().parent / "data" / "pretrained"
HANG_GUARD_S = 240
SERVE_BATCH = 64  # the engine's largest bucket: the main path's batch
N_RECONSTRUCT, N_THREADS, N_ENCODE, N_DECODE = 64, 8, 16, 16
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain version, both fp32 on the card, summed in another order;
# the factorization amplifies G^{-1} rounding by up to its condition number
CHOL_RTOL, CHOL_ATOL = 1e-4, 1e-5
# IAF chain: |kernel - plain| <= IAF_RTOL * (largest |z| of that transition);
# at the reference init, the kernel's error against fp64 is at most
# IAF_FP64_FACTOR times the plain fp32 version's (or within IAF_RTOL)
IAF_RTOL = 1e-4
IAF_FP64_FACTOR = 4.0

T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls, after warm-up."""
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


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------


def chol_cases(torch, dev):
    """(label, z, centroids, matrices, inv_t2, diag) at the serving path's row
    counts for the model's metric, the K=200 metric and a K=20 000 bank."""
    from rlvae_tpu_torch.geometry import load_metric

    rng = np.random.default_rng(0)
    banks = []
    for name, t_over in (("metric_T0.7_scaled.npz", 3.0), ("metric.npz", None)):
        m = load_metric(PRETRAINED / name, temperature_override=t_over)
        banks.append((f"{name}(K={m.n_centroids})", m.centroids.numpy(), m.matrices.numpy(),
                      m.temperature, m.regularization))
    k, d = 20_000, 16
    c = rng.normal(size=(k, d)).astype(np.float32)
    a = (rng.normal(size=(k, d, d)) / np.sqrt(d)).astype(np.float32)
    mats = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)
    banks.append(("synthetic(K=20000)", c, mats, 0.5, 0.01))
    for label, c, mats, temp, reg in banks:
        for b in (1, 7, SERVE_BATCH):
            z = c[rng.integers(0, c.shape[0], size=b)] + 0.05 * rng.normal(size=(b, c.shape[1]))
            yield (f"{label},B={b}", torch.tensor(z, dtype=torch.float32, device=dev),
                   torch.tensor(c, device=dev), torch.tensor(mats, device=dev),
                   1.0 / temp ** 2, reg + 1e-6)


def run_chol_checks(torch, dev):
    from rlvae_tpu_torch.ops.metric_kernels import chol_bundle, chol_bundle_ref

    cases, record = [], None
    for label, z, c, m, inv_t2, diag in chol_cases(torch, dev):
        l_k, ld_k = chol_bundle(z, c, m, inv_t2, diag)
        l_p, ld_p = chol_bundle_ref(z, c, m, inv_t2, diag)
        torch.cuda.synchronize()
        err = max(float((l_k - l_p).abs().max()), float((ld_k - ld_p).abs().max()))
        ok = bool(torch.all((l_k - l_p).abs() <= CHOL_ATOL + CHOL_RTOL * l_p.abs())
                  and torch.all((ld_k - ld_p).abs() <= CHOL_ATOL + CHOL_RTOL * ld_p.abs()))
        case = {"shape": label, "max_abs_err": err, "ok": ok,
                "ms": time_ms(torch, lambda: chol_bundle(z, c, m, inv_t2, diag), 20)}
        cases.append(case)
        check(ok, f"chol_bundle disagrees with its plain version at {label}: {err}")
        if label.startswith("metric_T0.7") and label.endswith(f"B={SERVE_BATCH}"):
            b, k = z.shape[0], c.shape[0]
            flops = b * (k * (3 * 16 + 1 + 2 * 16 * 16) + 16 ** 3 / 3 + 16)
            bms, by = bound_ms(nbytes(z, c, m, l_k, ld_k), flops)
            record = {
                "name": "chol_bundle", "route": "cuda",
                "source": "rlvae_tpu_torch/csrc/chol_bundle.cu",
                "replaces": "rlvae_tpu/ops/metric_kernels.py:470",
                "shape": label, "ms": case["ms"],
                "plain_ms": time_ms(torch, lambda: chol_bundle_ref(z, c, m, inv_t2, diag), 10),
                "bound_ms": bms, "bound_by": by, "library_ms": None,
            }
    record["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    record["tolerance"] = f"|kernel-plain| <= {CHOL_ATOL} + {CHOL_RTOL}*|plain|"
    return record, cases


def _scaled_err(got, want):
    """max over transitions of max|got-want| / max|want| (per transition)."""
    scale = want.abs().flatten(1).max(1).values.clamp_min(1e-30)
    return float(((got - want).abs().flatten(1).max(1).values / scale).max())


def run_iaf_checks(torch, dev):
    from rlvae_tpu_torch.flows import TemporalFlows
    from rlvae_tpu_torch.models import PRESETS
    from rlvae_tpu_torch.ops.iaf_kernels import iaf_chain_fwd, iaf_chain_fwd_ref, stack_chain

    p = PRESETS["riemannian_flow_vae"]
    nt = 7  # 8 frames -> 7 transitions

    def flows(bias):
        g = torch.Generator().manual_seed(0)
        return TemporalFlows(p["latent_dim"], p["n_flows"], p["flow_hidden_size"],
                             p["flow_n_blocks"], p["flow_n_hidden"],
                             log_var_bias_init=bias, generator=g).to(dev).requires_grad_(False)

    def chain_of(tf):
        return [tf.flows[min(t, tf.n_flows - 1)] for t in range(nt)]

    near_id, model_init = flows(0.0), flows(p["flow_log_var_bias_init"])
    rng = np.random.default_rng(1)
    cases, record = [], None
    for b in (1, 7, SERVE_BATCH):
        z0 = torch.tensor(rng.normal(size=(b, 16)), dtype=torch.float32, device=dev)
        # (a) the whole chain, near-identity flows: errors stay at rounding
        w = stack_chain(chain_of(near_id))
        z_k, ld_k = iaf_chain_fwd(z0, *w)
        z_p, ld_p = iaf_chain_fwd_ref(z0, *w)
        rel_a = max(_scaled_err(z_k, z_p), _scaled_err(ld_k, ld_p))
        abs_a = max(float((z_k - z_p).abs().max()), float((ld_k - ld_p).abs().max()))
        # (b) the model's reference-init flows, which scale |z| ~20x per
        # transition: rounding is amplified inside each transition, so the
        # kernel is held to an fp64 evaluation, no less accurate than the plain
        # fp32 version; each transition starts from the fp64 chain's input to it
        wm = stack_chain(chain_of(model_init))
        wm64 = [w.double() for w in wm]
        z_64, _ = iaf_chain_fwd_ref(z0.double(), *wm64)
        rel_b = rel_p = abs_b = abs_kp = 0.0
        for t in range(nt):
            x_in = (z0 if t == 0 else z_64[t - 1].float()).contiguous()
            w_t = [x[t : t + 1].contiguous() for x in wm]
            zt, ldt = iaf_chain_fwd(x_in, *w_t)
            zp, ldp = iaf_chain_fwd_ref(x_in, *w_t)
            ze, lde = iaf_chain_fwd_ref(x_in.double(), *(x[t : t + 1] for x in wm64))
            rel_b = max(rel_b, _scaled_err(zt.double(), ze), _scaled_err(ldt.double(), lde))
            rel_p = max(rel_p, _scaled_err(zp.double(), ze), _scaled_err(ldp.double(), lde))
            abs_b = max(abs_b, float((zt.double() - ze).abs().max()))
            abs_kp = max(abs_kp, float((zt - zp).abs().max()), float((ldt - ldp).abs().max()))
        torch.cuda.synchronize()
        ok = rel_a <= IAF_RTOL and rel_b <= max(IAF_FP64_FACTOR * rel_p, IAF_RTOL)
        case = {"shape": f"B={b},D=16,H=256,NB=2,NH=3,NT={nt}", "ok": ok,
                "chain_near_identity": {"max_rel_err": rel_a, "max_abs_err": abs_a},
                "per_transition_model_init_vs_fp64": {
                    "kernel_max_rel_err": rel_b, "plain_fp32_max_rel_err": rel_p,
                    "kernel_max_abs_err": abs_b, "kernel_vs_plain_max_abs_err": abs_kp},
                "max_abs_err": max(abs_a, abs_kp),
                "ms": time_ms(torch, lambda: iaf_chain_fwd(z0, *wm), 10)}
        cases.append(case)
        check(ok, f"iaf_chain_fwd disagrees at B={b}: {rel_a}, {rel_b} (plain fp32 {rel_p})")
        if b == SERVE_BATCH:
            h, d, nb, nh = 256, 16, 2, 3
            flops = b * nt * nb * d * 2 * (d * h + (nh - 1) * h * h + h * 2 * d)
            bms, by = bound_ms(nbytes(z0, *wm, z_k, ld_k), flops)
            record = {
                "name": "iaf_chain_fwd", "route": "cuda",
                "source": "rlvae_tpu_torch/csrc/iaf_chain.cu",
                "replaces": "rlvae_tpu/ops/iaf_kernels.py:546",
                "shape": case["shape"], "ms": case["ms"],
                "plain_ms": time_ms(torch, lambda: iaf_chain_fwd_ref(z0, *wm), 2, warmup=1),
                "bound_ms": bms, "bound_by": by, "library_ms": None,
            }
    record["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    record["tolerance"] = (f"near-identity chain: |kernel-plain| <= {IAF_RTOL}*max|plain| per "
                           f"transition; reference init: error vs fp64 <= max({IAF_FP64_FACTOR}x "
                           f"the plain fp32 version's, {IAF_RTOL}) per transition")
    return record, cases


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


def run_serve(torch):
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig
    from rlvae_tpu_torch.ops.iaf_kernels import iaf_chain_fwd
    from rlvae_tpu_torch.ops.metric_kernels import chol_bundle

    t_load = time.perf_counter()
    manager = ModelManager.from_config(PRESETS["riemannian_flow_vae"], seed=0)
    check(manager.device.type == "cuda", f"manager on {manager.device}")
    load_s = time.perf_counter() - t_load
    rng = np.random.default_rng(2)
    seqs = rng.uniform(size=(N_RECONSTRUCT, 8, 3, 64, 64)).astype(np.float32)
    frames = seqs[:N_ENCODE, 0]
    latents = rng.normal(size=(N_DECODE, 16)).astype(np.float32)

    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(1, 2, 4, 8, 16, 32, 64)))
    results, errors = {}, []
    try:
        # every (op, bucket) once, so the stats below are of a warm engine
        engine.warmup({"reconstruct": seqs[0], "encode": frames[0], "decode": latents[0]})
        torch.cuda.synchronize()
        chol_bundle.launches = 0
        iaf_chain_fwd.launches = 0
        t_serve = time.perf_counter()

        def client(tid: int) -> None:
            try:
                idx = range(tid, N_RECONSTRUCT, N_THREADS)
                futs = {i: engine.submit("reconstruct", seqs[i]) for i in idx}
                for i, f in futs.items():
                    results[i] = f.result(timeout=60)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(N_THREADS)]
        for t in threads:
            t.start()
        enc = [engine.submit("encode", f) for f in frames]
        dec = [engine.submit("decode", z) for z in latents]
        enc_out = [f.result(timeout=60) for f in enc]
        dec_out = [f.result(timeout=60) for f in dec]
        for t in threads:
            t.join(timeout=120)
        serve_s = time.perf_counter() - t_serve
        launches = {"chol_bundle": chol_bundle.launches, "iaf_chain_fwd": iaf_chain_fwd.launches}
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
    check(not any(t.is_alive() for t in threads), "a client thread did not finish")
    if errors:
        raise errors[0]
    check(sorted(results) == list(range(N_RECONSTRUCT)), "missing reconstruct results")
    for r in results.values():
        check(r.shape == (8, 3, 64, 64) and np.isfinite(r).all(), "bad reconstruct result")
    check(all(e.shape == (16,) and np.isfinite(e).all() for e in enc_out), "bad encode result")
    check(all(x.shape == (3, 64, 64) and np.isfinite(x).all() for x in dec_out), "bad decode result")
    check(launches["chol_bundle"] > 0 and launches["iaf_chain_fwd"] > 0,
          f"the serving path did not launch both kernels: {launches}")
    check(launches["chol_bundle"] == 2 * launches["iaf_chain_fwd"],
          f"expected 2 chol-bundle launches per IAF-chain launch: {launches}")

    # one B=64 forward on the card vs the same model on the CPU (plain versions)
    x = seqs[:SERVE_BATCH]
    eps = torch.tensor(rng.normal(size=(SERVE_BATCH, 16)), dtype=torch.float32)
    out_gpu = manager.forward(x, eps=eps.to(manager.device))
    torch.cuda.synchronize()
    cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu")
    out_cpu = cpu.forward(x, eps=eps)
    compare = compare_forward(torch, out_gpu, out_cpu)
    return {"launches": launches, "stats": stats, "serve_s": serve_s, "load_s": load_s,
            "requests": {"reconstruct": N_RECONSTRUCT, "encode": N_ENCODE, "decode": N_DECODE},
            "threads": N_THREADS, "cuda_vs_cpu": compare,
            "forward_b64": profile_forward(torch, manager, x, eps.to(manager.device))}


def profile_forward(torch, manager, x, eps):
    """Warm B=64 forward: ms from CUDA events (device-side, inputs already
    on the card), ``reconstruct`` ms on the host clock (upload and copy-back
    included), and one profiled forward's device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    xd = torch.from_numpy(x).to(manager.device)
    fwd_ms = time_ms(torch, lambda: manager.forward(xd, eps=eps), 5)
    host = []
    for _ in range(5):
        t = time.perf_counter()
        manager.reconstruct(x)
        host.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        manager.forward(xd, eps=eps)
        torch.cuda.synchronize()
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0 and "cuda" in str(getattr(evt, "device_type", "")).lower():
            kernels.append({"name": evt.key[:80], "us": float(us), "calls": int(evt.count)})
    kernels.sort(key=lambda k: -k["us"])
    busy_ms = sum(k["us"] for k in kernels) / 1e3
    return {"forward_ms": fwd_ms, "reconstruct_host_ms_median": float(np.median(host)),
            "profiled_device_busy_ms": busy_ms, "n_kernel_names": len(kernels),
            "top_kernels": kernels[:10]}


# End-to-end tolerances, card vs CPU.  The nets run bf16 activations, which
# the two devices may round at other places (a bf16 step is 2^-8 relative);
# the reference-init flows then scale the latent ~20x per transition, so
# everything after z0 is compared as aggregates relative to its own scale.
E2E_TOL = {
    "mu": 1e-3, "log_var": 1e-3,        # abs, bf16 encoder
    "z0": 1e-3,                          # abs, mu + L eps
    "kld_loss": 1e-3,                    # rel
    "z_rel": 1e-3,                       # |dz| / max|z| per time step
    "recon_mean_abs": 1e-4,              # mean |d recon|, pixels in [0, 1]
    "recon_loss": 1e-3, "flow_loss": 1e-3, "loss": 1e-3,  # rel
}


def compare_forward(torch, a, b):
    a = {k: v.float().cpu() for k, v in a.items()}
    b = {k: v.float() for k, v in b.items()}
    for k, v in a.items():
        check(bool(torch.isfinite(v).all()), f"non-finite {k} on the card")
    rel = lambda k: float((a[k] - b[k]).abs() / b[k].abs().clamp_min(1e-12))
    z_scale = b["z"].abs().amax(dim=(0, 2)).clamp_min(1e-12)
    got = {
        "mu": float((a["mu"] - b["mu"]).abs().max()),
        "log_var": float((a["log_var"] - b["log_var"]).abs().max()),
        "z0": float((a["z"][:, 0] - b["z"][:, 0]).abs().max()),
        "kld_loss": rel("kld_loss"),
        "z_rel": float(((a["z"] - b["z"]).abs().amax(dim=(0, 2)) / z_scale).max()),
        "recon_mean_abs": float((a["recon_x"] - b["recon_x"]).abs().mean()),
        "recon_loss": rel("recon_loss"), "flow_loss": rel("flow_loss"), "loss": rel("loss"),
    }
    for k, tol in E2E_TOL.items():
        check(got[k] <= tol, f"card vs CPU forward: {k} = {got[k]} > {tol}")
    return {"errors": got, "tolerances": E2E_TOL,
            "recon_max_abs": float((a["recon_x"] - b["recon_x"]).abs().max())}


def main() -> None:
    faulthandler.dump_traceback_later(HANG_GUARD_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    from rlvae_tpu_torch.ops.build import kernel_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    lib = kernel_library()
    emit("build", seconds=lib.seconds, library=str(lib.path.name),
         ptxas=[ln.strip() for ln in lib.log.splitlines() if "registers" in ln or "spill" in ln])
    print(f"build_seconds {lib.seconds:.3f}", flush=True)

    from rlvae_tpu_torch.ops.iaf_kernels import iaf_chain_fwd
    from rlvae_tpu_torch.ops.metric_kernels import chol_bundle

    chol_rec, chol_cases_out = run_chol_checks(torch, dev)
    iaf_rec, iaf_cases_out = run_iaf_checks(torch, dev)
    emit("kernels",
         chol_bundle={"tolerance": chol_rec["tolerance"], "launches": chol_bundle.launches,
                      "cases": chol_cases_out},
         iaf_chain_fwd={"tolerance": iaf_rec["tolerance"], "launches": iaf_chain_fwd.launches,
                        "cases": iaf_cases_out})

    serve = run_serve(torch)
    emit("serve", **serve)
    chol_rec["launches"] = serve["launches"]["chol_bundle"]
    iaf_rec["launches"] = serve["launches"]["iaf_chain_fwd"]

    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": [chol_rec, iaf_rec]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
