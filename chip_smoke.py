"""Smoke run of the PyTorch/CUDA port (rlvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:

1. ``device``: the card's name, count, and ``nvidia-smi`` name and power limit.
2. ``build``: one ``nvcc`` per ``rlvae_tpu_torch/csrc/*.cu``, all started
   together, then one link; the ``-Xptxas -v`` lines of every kernel.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the shapes the serving and training paths give it, with the tolerance
   stated; ms per launch from CUDA events around back-to-back wrapper calls
   (``ms``, host issue time included where the host is the slower), and
   device ms per launch from a CUDA graph of GRAPH_LAUNCHES launches,
   replayed (``device_ms``).  The IAF-chain forward (B = 1, 7,
   16, 64) and backward (B = 1, 16, 64) are held to their plain versions at
   the near-identity flow init and, at the model's reference init, to an
   fp64 evaluation, in both instantiations (weights resident in shared
   memory, and streamed), bit-identical on relaunch; each batch prints the
   launcher's cluster geometry.  The HMC terms,
   the metric bundle and G^{-1} are held to their plain versions and to an
   fp64 evaluation at K=50, 200 and 20 000, B=1, 64 and 1000 (the HMC terms
   also at B=37 and on a K=37 bank padded to 40: every geometry their rule
   picks, each case printing it), with rows far from every centroid; the
   HMC terms bit-identical on relaunch and in a graph replay.  The decode+MSE forward, dh and dW/db are held to
   their plain versions (the forward's loss also to fp64) at M=128 (the fast
   train step's B=16), 512 and 37 rows, N=12288 and 300, on the pretrained
   decoder's weights, bit-identical on relaunch and in a CUDA-graph replay;
   each is timed at M=128 and 512, warm (``device_ms``) and cold (each
   launch after a 256 MB write that evicts the L2, the write's own time
   subtracted: ``cold_ms``), beside cuBLAS's time for the entry point's
   last bf16 product alone.  The HMC partials (one shard's
   G^{-1} sum and gradient contraction) are held to their plain version and
   to fp64 at K=50, 200, 20 000 and 37 padded to 40, B=64, 37, 1 and 1000,
   bit-identical on relaunch and in a graph replay, with the geometry of
   each case.
4. ``serve``: ``ModelManager.from_config(PRESETS["riemannian_flow_vae"])`` on
   the card behind a ``BatchingEngine``; 64 ``reconstruct`` requests from 8
   threads plus 16 ``encode`` and 16 ``decode``, after one warm-up call per
   (op, bucket).  The launch counters are zeroed just before the requests
   and read just after; one B=64 forward on the card is held against the
   same model moved to the CPU, and one is profiled.
5. ``train``: ``Trainer`` takes 5 Adam steps of the full-width preset at
   B=16 on synthetic sequences (training preset ``default``).  The launch
   counters are zeroed just before ``fit`` and read just after, and read
   around every step (chol-bundle 2, IAF-chain forward 1, backward 1); the
   validation pass reports the six analysis metrics and launches G^{-1}.  Each
   card step is replayed on the CPU from the card's weights and optimizer
   state just before it, with the same batch and noise; losses, grad_norm
   and the step-1 gradients are compared.  One warm step is timed with CUDA
   events and one is profiled.
6. ``generate``: a full-width ``ModelManager`` on the card generates through
   ``sample_random_batched_seeds`` at B=1 and B=64 with the ``geodesic``
   prior and the ``official`` manifold-HMC chain, and at B=64 with the other
   prior methods and the ``hmc`` chain.  The launch counters are zeroed just
   before and read just after, and around each call (1601 ``hmc_terms``
   launches per chain).  One ``official`` call is profiled.  The card's
   official chain is replayed step by step on the CPU from the card's state
   before each step with the same noise; one geodesic batch is decoded on
   the card and on the CPU from the same draws.  Then an engine with
   ``generate_method="official"`` answers concurrent seeds [7, 123, 7, 999]
   and a lone request, each row against ``sample_random(1, seed)``.
7. ``posterior``: ``PRESETS["hybrid_rlvae"]`` (Gaussian posterior, K=200
   metric at T=0.7) with ``sampling.method: geodesic`` behind a
   ``BatchingEngine``: 64 ``reconstruct`` requests in one B=64 bucket, one
   metric-bundle launch per forward; host-clock and device time of a warm
   B=64 forward, which is held against the CPU on the same noise.  Then 3
   ``Trainer`` steps of the geodesic model at B=16, each replayed on the CPU
   as in the train phase, with a validation pass that launches G^{-1}.  Then
   the shipped ``hybrid_rlvae`` (``enhanced``) reconstructs once.
8. ``fast``: ``PRESETS["riemannian_flow_vae_fast"]`` (sampling-direction
   flows, fused decode+MSE loss): 5 ``Trainer`` steps at B=16 as in the
   train phase (per step: chol-bundle 2, ``decode_mse`` forward, dh and
   dW/db 1 each, no IAF-chain launch), each replayed on the CPU, with a
   validation pass; then one warm B=64 ``reconstruct`` bucket behind a
   ``BatchingEngine`` (chol-bundle 2, nothing else) and a B=64 forward held
   against the CPU.
9. ``ep``: the centroid-sharded (expert-parallel) HMC path of
   ``rlvae_tpu_torch.parallel`` in one process on the 1 x 1 mesh, on the
   default model's K=50 metric at T=3.0.  ``hmc_terms_sharded`` is held
   against ``hmc_terms`` at K=50 and 20 000, and the bank split into 4
   padded shards (``hmc_partials`` on each, summed in shard order, then the
   epilogue) against the whole bank.  ``sample_prior_hmc_sharded`` runs the
   official chain (100 x 15) at B=64 with the counters zeroed just before
   and read just after (1601 ``hmc_partials`` launches, no ``hmc_terms``);
   host-clock time, and the busy share of a profiled 2-step chain.
   ``chol_g_inv_sharded`` at B=64 launches the G^{-1} kernel once and is
   held to the dense chol-bundle factor.  Every
   MCMC step is replayed on the CPU from the card's state, and the first 10
   are also taken with the dense ``hmc_terms`` from the same state.
10. ``dense_chain``: the official chain (100 x 15) at B=64 through
   ``sample_prior_hmc`` on the K=20 000 synthetic bank, where B4 sets the
   wall time: host seconds with the counters zeroed just before and read
   just after (1601 ``hmc_terms``), the profiled device time and busy share
   of a second run, and the first DENSE_REPLAY_STEPS MCMC steps replayed on
   the CPU from the card's state (also with every proposal accepted, so
   that the leapfrog endpoints are compared where the chain rejects).

Then a ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
run exits non-zero; a hang dumps every thread's stack and exits.  Without a
CUDA card the run fails at once.
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
HANG_GUARD_S = 540
SERVE_BATCH = 64  # the engine's largest bucket: the main path's batch
N_RECONSTRUCT, N_THREADS, N_ENCODE, N_DECODE = 64, 8, 16, 16
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# dense bf16 on the tensor cores: the bound of decode+MSE's products
PEAK_BF16_TENSOR_FLOPS = 989e12
# kernel vs plain version, both fp32 on the card, summed in another order;
# the factorization amplifies G^{-1} rounding by up to its condition number
CHOL_RTOL, CHOL_ATOL = 1e-4, 1e-5
# IAF chain: |kernel - plain| <= IAF_RTOL * (largest |z| of that transition);
# at the reference init, the kernel's error against fp64 is at most
# IAF_FP64_FACTOR times the plain fp32 version's (or within IAF_RTOL)
IAF_RTOL = 1e-4
IAF_FP64_FACTOR = 4.0
# the training path's batch, and the batches the backward kernel is timed at
TRAIN_BATCH, TRAIN_STEPS = 16, 5
BWD_BATCHES = (1, TRAIN_BATCH, SERVE_BATCH)
N_TRANSITIONS = 7  # 8 frames -> 7 transitions
# HMC terms: log pi within HMC_LP_ATOL and grad within HMC_RTOL of its
# largest entry, kernel vs plain fp32; against fp64, the kernel's error at
# most IAF_FP64_FACTOR times the plain fp32 version's (or HMC_RTOL of scale):
# the gradient goes through an inverse of G^{-1}
HMC_LP_ATOL, HMC_RTOL = 1e-5, 1e-4
HMC_BATCHES = (1, SERVE_BATCH, 1000)
# the HMC terms and partials at every geometry their rule picks for K = 50,
# 200 and 20 000 (csrc/hmc_bank.cuh: rows blocked 1, 2, 4 or 8 a CTA; the cluster
# size the largest, up to 8, whose clusters the card holds in one wave, e.g.
# 6 at B=64, K=20 000 on the H100)
HMC_KERNEL_BATCHES = (1, 37, SERVE_BATCH, 1000)
# device time per launch: this many launches captured in one CUDA graph
GRAPH_LAUNCHES = 20
# generation: the batches of sample_random_batched_seeds, the chain's launches
GEN_BATCHES = (1, SERVE_BATCH)
CHAIN_LAUNCHES = 1 + 100 * (15 + 1)
# card chain vs its CPU replay, per MCMC step from the card's state: z within
# CHAIN_Z_RTOL of max(1, |z|) (15 fp32 leapfrog steps); the accept decision
# identical unless |u - alpha| < ACCEPT_MARGIN (alpha is exp of a difference
# of fp32 sums, which the two devices round apart)
CHAIN_Z_RTOL, ACCEPT_MARGIN = 1e-4, 1e-3
SERVE_SEEDS = (7, 123, 7, 999)
# metric bundle and G^{-1}, kernel vs plain fp32 (the JAX package's kernel
# tolerances: G^{-1}, L, logdet, G); against fp64, each output's error at most
# BUNDLE_FP64_FACTOR times the plain fp32 version's, or BUNDLE_FP64_RTOL of
# the output's scale
BUNDLE_TOL = {"g_inv": (1e-5, 1e-6), "l": (1e-4, 1e-4), "logdet": (1e-4, 1e-4),
              "g": (1e-3, 1e-3)}
BUNDLE_FP64_FACTOR, BUNDLE_FP64_RTOL = 2.0, 1e-5
# the posterior phase: Trainer steps of the geodesic hybrid model
POSTERIOR_TRAIN_STEPS = 3
# decode+MSE: the kernel vs its plain version on the card, the loss rtol and
# each gradient's error relative to its largest entry (a bf16 rounding of dp
# may flip where the fp32 pre-activation is summed in another order; dh as
# its fp32 sum, from an fp32 h); the bf16 dh of a bf16 h within one bf16 step
# (2^-7) of each element on top of that (its final rounding flips where the
# fp32 sum, taken in another order, lies near a tie); vs an fp64 evaluation
# of the same bf16 operands, the loss's error at most DECODE_FP64_FACTOR
# times the plain fp32 version's, or DECODE_FP64_RTOL
DECODE_LOSS_RTOL, DECODE_GRAD_RTOL = 1e-5, 1e-3
DECODE_FP64_FACTOR, DECODE_FP64_RTOL = 2.0, 1e-6
DECODE_ROWS = (TRAIN_BATCH * 8, 512, 37)  # B*T rows: the fast train step's, a larger, a ragged
DECODE_COLS = (12288, 300)
DECODE_TIMED_ROWS = (TRAIN_BATCH * 8, 512)
DECODE_FLUSH_BYTES = 256 << 20  # written between cold launches: 5x the H100's 50 MB L2
# HMC partials, kernel vs plain fp32: gi_part and v within these multiples of
# max(1, |plain|) elementwise (sums over K in another order); against fp64,
# the kernel's error at most IAF_FP64_FACTOR times the plain version's, or
# PARTIALS_FP64_RTOL of scale
PARTIALS_TOL = {"gi_part": 1e-5, "v": 1e-4}
PARTIALS_FP64_RTOL = 1e-5
PARTIALS_BATCHES = (SERVE_BATCH, 37, 1, 1000)
# the ep phase: shards of the in-process split, and the dense steps compared
EP_SHARDS, EP_DENSE_STEPS, EP_PROFILE_STEPS = 4, 10, 2
# the dense_chain phase: the official chain on the K=20 000 bank, its first
# steps replayed on the CPU
DENSE_REPLAY_STEPS = 3
# the analysis metrics of the evaluation step (losses.additional_metrics)
EVAL_METRIC_KEYS = ("cyclicity_error", "latent_norm", "latent_variance",
                    "metric_conditioning", "manifold_regularity", "metric_determinant")

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


def device_ms(torch, fn, n: int = GRAPH_LAUNCHES, replays: int = 3):
    """(device ms per call, outputs): ``fn`` captured ``n`` times in one CUDA
    graph, replayed once, then ``replays`` times between CUDA events, so no
    host issue time is inside; the outputs are the last captured call's after
    the replays.  A launcher that cannot be captured raises."""
    fn()  # warm-up outside the graph
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


def cold_device_ms(torch, fn, flush, n: int = GRAPH_LAUNCHES) -> float:
    """Device ms per call of ``fn`` with the L2 cache evicted before each: a
    CUDA graph of (write ``flush``, ``fn``) pairs less one of the writes
    alone, both replayed as in :func:`device_ms`."""
    write = lambda: flush.fill_(1.0)  # noqa: E731

    def pair():
        write()
        return fn()

    return device_ms(torch, pair, n)[0] - device_ms(torch, write, n)[0]


def graph_replay_equal(torch, fn, eager) -> bool:
    """``fn`` captured once in a CUDA graph (after the eager launches that gave
    ``eager``), replayed: the same bits as ``eager``."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, c) for a, c in zip(out, eager))


def with_device_ms(torch, record, fn):
    """``record`` with the device time per launch of ``fn`` (its kernel at the
    record's shape) beside its CUDA-event ``ms``."""
    record["device_ms"], _ = device_ms(torch, fn)
    return record


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------


def metric_banks():
    """(label, centroids, matrices, temperature, lbd): the model's metric, the
    K=200 metric and a K=20 000 synthetic bank."""
    from rlvae_tpu_torch.geometry import load_metric

    banks = []
    for name, t_over in (("metric_T0.7_scaled.npz", 3.0), ("metric.npz", None)):
        m = load_metric(PRETRAINED / name, temperature_override=t_over)
        banks.append((f"{name}(K={m.n_centroids})", m.centroids.numpy(), m.matrices.numpy(),
                      m.temperature, m.regularization))
    rng = np.random.default_rng(0)
    k, d = 20_000, 16
    c = rng.normal(size=(k, d)).astype(np.float32)
    a = (rng.normal(size=(k, d, d)) / np.sqrt(d)).astype(np.float32)
    mats = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)
    banks.append(("synthetic(K=20000)", c, mats, 0.5, 0.01))
    return banks


def chol_cases(torch, dev):
    """(label, z, centroids, matrices, inv_t2, diag) at the serving path's row
    counts for each bank of :func:`metric_banks`."""
    rng = np.random.default_rng(0)
    for label, c, mats, temp, reg in metric_banks():
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
            record = with_device_ms(torch, {
                "name": "chol_bundle", "route": "cuda",
                "source": "rlvae_tpu_torch/csrc/chol_bundle.cu",
                "replaces": "rlvae_tpu/ops/metric_kernels.py:470",
                "shape": label, "ms": case["ms"],
                "plain_ms": time_ms(torch, lambda: chol_bundle_ref(z, c, m, inv_t2, diag), 10),
                "bound_ms": bms, "bound_by": by, "library_ms": None,
            }, lambda: chol_bundle(z, c, m, inv_t2, diag))
    record["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    record["tolerance"] = f"|kernel-plain| <= {CHOL_ATOL} + {CHOL_RTOL}*|plain|"
    return record, cases


def _scaled_err(got, want):
    """max over transitions of max|got-want| / max|want| (per transition)."""
    scale = want.abs().flatten(1).max(1).values.clamp_min(1e-30)
    return float(((got - want).abs().flatten(1).max(1).values / scale).max())


def chain_weights(torch, dev, bias):
    """The stacked weights of the preset's 7-transition chain, flows at the
    seeded init with log-sigma bias ``bias`` (0.0: near-identity flows;
    the preset's -2.0: the model's reference init)."""
    from rlvae_tpu_torch.flows import TemporalFlows
    from rlvae_tpu_torch.models import PRESETS
    from rlvae_tpu_torch.ops.iaf_kernels import stack_chain

    p = PRESETS["riemannian_flow_vae"]
    g = torch.Generator().manual_seed(0)
    tf = TemporalFlows(p["latent_dim"], p["n_flows"], p["flow_hidden_size"],
                       p["flow_n_blocks"], p["flow_n_hidden"],
                       log_var_bias_init=bias, generator=g).to(dev).requires_grad_(False)
    return stack_chain([tf.flows[min(t, tf.n_flows - 1)] for t in range(N_TRANSITIONS)])


def pass_flops(d=16, h=256, nh=3):
    """FLOP of one MADE pass for one row."""
    return 2 * (d * h + (nh - 1) * h * h + h * 2 * d)


IAF_FWD_BATCHES = (1, 7, TRAIN_BATCH, SERVE_BATCH)


def iaf_instantiations():
    """The two instantiations of each IAF-chain kernel: weights resident in
    shared memory (what the wrappers launch at the preset's shape) and
    streamed from global memory (what they launch where the weights do not
    fit), both driven at the same shape."""
    from rlvae_tpu_torch.ops.iaf_kernels import _launch_bwd, _launch_fwd

    return {
        "resident": (lambda z0, w, ys=False: _launch_fwd(z0, tuple(w), ys),
                     lambda ys, dz, dld, w: _launch_bwd(ys, dz, dld, tuple(w))),
        "streamed": (lambda z0, w, ys=False: _launch_fwd(z0, tuple(w), ys, stream_weights=True),
                     lambda ys, dz, dld, w: _launch_bwd(ys, dz, dld, tuple(w),
                                                        stream_weights=True)),
    }


def run_iaf_checks(torch, dev):
    from rlvae_tpu_torch.ops.iaf_kernels import (
        iaf_chain_fwd,
        iaf_chain_fwd_ref,
        launch_geometry,
    )

    nt = N_TRANSITIONS
    w_near_id = chain_weights(torch, dev, 0.0)
    wm = chain_weights(torch, dev, -2.0)
    wm64 = [w.double() for w in wm]
    rng = np.random.default_rng(1)
    cases, record = [], None
    for b in IAF_FWD_BATCHES:
        z0 = torch.tensor(rng.normal(size=(b, 16)), dtype=torch.float32, device=dev)
        z_p, ld_p, ys_p = iaf_chain_fwd_ref(z0, *w_near_id, return_ys=True)
        z_64, _ = iaf_chain_fwd_ref(z0.double(), *wm64)
        plain_t = []  # per transition: (input, plain fp32 z and ld, fp64 z and ld)
        for t in range(nt):
            x_in = (z0 if t == 0 else z_64[t - 1].float()).contiguous()
            w_t = [x[t : t + 1].contiguous() for x in wm]
            plain_t.append((x_in, w_t, iaf_chain_fwd_ref(x_in, *w_t),
                            iaf_chain_fwd_ref(x_in.double(), *(x[t : t + 1] for x in wm64))))
        case = {"shape": f"B={b},D=16,H=256,NB=2,NH=3,NT={nt}",
                "geometry": launch_geometry(b, 16, 256, 3), "ok": True, "max_abs_err": 0.0}
        for inst, (fwd, _) in iaf_instantiations().items():
            # (a) the whole chain, near-identity flows: errors stay at rounding;
            # the residual ys (each block's output) too
            z_k, ld_k, ys_k = fwd(z0, w_near_id, True)
            check(torch.equal(fwd(z0, w_near_id)[0], z_k), "ys output changed z")
            check(torch.equal(fwd(z0, w_near_id, True)[2], ys_k), "relaunch changed ys")
            rel_a = max(_scaled_err(z_k, z_p), _scaled_err(ld_k, ld_p), _scaled_err(ys_k, ys_p))
            abs_a = max(float((z_k - z_p).abs().max()), float((ld_k - ld_p).abs().max()),
                        float((ys_k - ys_p).abs().max()))
            # (b) the model's reference-init flows, which scale |z| ~20x per
            # transition: rounding is amplified inside each transition, so the
            # kernel is held to an fp64 evaluation, no less accurate than the
            # plain fp32 version; each transition starts from the fp64 chain's
            # input to it
            rel_b = rel_p = abs_b = abs_kp = 0.0
            for x_in, w_t, (zp, ldp), (ze, lde) in plain_t:
                zt, ldt = fwd(x_in, w_t)
                rel_b = max(rel_b, _scaled_err(zt.double(), ze), _scaled_err(ldt.double(), lde))
                rel_p = max(rel_p, _scaled_err(zp.double(), ze), _scaled_err(ldp.double(), lde))
                abs_b = max(abs_b, float((zt.double() - ze).abs().max()))
                abs_kp = max(abs_kp, float((zt - zp).abs().max()), float((ldt - ldp).abs().max()))
            torch.cuda.synchronize()
            ok = rel_a <= IAF_RTOL and rel_b <= max(IAF_FP64_FACTOR * rel_p, IAF_RTOL)
            case[inst] = {
                "chain_near_identity": {"max_rel_err": rel_a, "max_abs_err": abs_a},
                "per_transition_model_init_vs_fp64": {
                    "kernel_max_rel_err": rel_b, "plain_fp32_max_rel_err": rel_p,
                    "kernel_max_abs_err": abs_b, "kernel_vs_plain_max_abs_err": abs_kp},
                "ms": time_ms(torch, lambda: fwd(z0, wm), 10), "ok": ok}
            case["ok"] &= ok
            case["max_abs_err"] = max(case["max_abs_err"], abs_a, abs_kp)
            check(ok, f"iaf_chain_fwd ({inst}) disagrees at B={b}: {rel_a}, {rel_b} "
                      f"(plain fp32 {rel_p})")
        case["ms"] = time_ms(torch, lambda: iaf_chain_fwd(z0, *wm), 10)
        cases.append(case)
        if b == SERVE_BATCH:
            d, nb = 16, 2
            flops = b * nt * nb * d * pass_flops()
            z_k, ld_k = iaf_chain_fwd(z0, *wm)
            bms, by = bound_ms(nbytes(z0, *wm, z_k, ld_k), flops)
            record = with_device_ms(torch, {
                "name": "iaf_chain_fwd", "route": "cuda",
                "source": "rlvae_tpu_torch/csrc/iaf_chain.cu",
                "replaces": "rlvae_tpu/ops/iaf_kernels.py:546",
                "shape": case["shape"], "ms": case["ms"],
                "plain_ms": time_ms(torch, lambda: iaf_chain_fwd_ref(z0, *wm), 2, warmup=1),
                "bound_ms": bms, "bound_by": by, "library_ms": None,
            }, lambda: iaf_chain_fwd(z0, *wm))
    record["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    record["ms_by_batch"] = {c["shape"].split(",")[0]: c["ms"] for c in cases}
    record["ms_streamed_by_batch"] = {c["shape"].split(",")[0]: c["streamed"]["ms"]
                                      for c in cases}
    record["tolerance"] = (f"near-identity chain: |kernel-plain| <= {IAF_RTOL}*max|plain| per "
                           f"transition (z, ld and the residual ys); reference init: error vs "
                           f"fp64 <= max({IAF_FP64_FACTOR}x the plain fp32 version's, {IAF_RTOL}) "
                           f"per transition; both instantiations (weights resident, streamed); "
                           f"bit-identical on relaunch")
    return record, cases


def _bwd_err(got, want):
    """Largest error of (dz0, weight grads) relative to scale: dz0 against
    its largest entry, each weight gradient per transition."""
    dz0_g, grads_g = got
    dz0_w, grads_w = want
    errs = [_scaled_err(dz0_g.double()[None], dz0_w.double()[None])]
    errs += [_scaled_err(a.double(), b.double()) for a, b in zip(grads_g, grads_w)]
    return max(errs)


def _bwd_abs(got, want):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip((got[0], *got[1]), (want[0], *want[1])))


def run_iaf_bwd_checks(torch, dev):
    """The IAF-chain backward against its plain version, in both
    instantiations: (a) the whole chain at the near-identity init, both from
    the same residual ys, bit-identical on relaunch; (b) at the reference
    init, each transition alone from the fp64 chain's residual, kernel and
    plain fp32 version both against fp64.  Each batch also times the
    caller's sum of the weight-gradient workspace (one slot per cluster)."""
    from rlvae_tpu_torch.ops.iaf_kernels import (
        bwd_workspace,
        iaf_chain_bwd,
        iaf_chain_bwd_ref,
        iaf_chain_fwd,
        iaf_chain_fwd_ref,
        launch_geometry,
    )

    nt, d = N_TRANSITIONS, 16
    w_near_id = chain_weights(torch, dev, 0.0)
    wm = chain_weights(torch, dev, -2.0)
    wm64 = [w.double() for w in wm]
    rng = np.random.default_rng(3)
    cases, record = [], None
    for b in BWD_BATCHES:
        z0 = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32, device=dev)
        dz = torch.tensor(rng.normal(size=(nt, b, d)), dtype=torch.float32, device=dev)
        dld = torch.tensor(rng.normal(size=(nt, b)), dtype=torch.float32, device=dev)
        _, _, ys = iaf_chain_fwd_ref(z0, *w_near_id, return_ys=True)
        want = iaf_chain_bwd_ref(ys, dz, dld, *w_near_id)
        _, _, ys64 = iaf_chain_fwd_ref(z0.double(), *wm64, return_ys=True)
        plain_t = []
        for t in range(nt):
            w_t = [x[t : t + 1].contiguous() for x in wm]
            args = (ys64[t : t + 1].float().contiguous(), dz[t : t + 1].contiguous(),
                    dld[t : t + 1].contiguous())
            plain_t.append((args, w_t, iaf_chain_bwd_ref(*args, *w_t),
                            iaf_chain_bwd_ref(*(a.double() for a in args),
                                              *(x[t : t + 1] for x in wm64))))
        _, _, ys_m = iaf_chain_fwd(z0, *wm, return_ys=True)
        case = {"shape": f"B={b},D=16,H=256,NB=2,NH=3,NT={nt}",
                "geometry": launch_geometry(b, 16, 256, 3, backward=True), "ok": True}
        for inst, (_, bwd) in iaf_instantiations().items():
            got = bwd(ys, dz, dld, w_near_id)
            again = bwd(ys, dz, dld, w_near_id)
            check(torch.equal(got[0], again[0]) and all(map(torch.equal, got[1], again[1])),
                  f"iaf_chain_bwd ({inst}) changed on relaunch at B={b}")
            rel_a, abs_a = _bwd_err(got, want), _bwd_abs(got, want)
            rel_b = rel_p = abs_kp = 0.0
            for args, w_t, p, e in plain_t:
                k = bwd(*args, w_t)
                rel_b, rel_p = max(rel_b, _bwd_err(k, e)), max(rel_p, _bwd_err(p, e))
                abs_kp = max(abs_kp, _bwd_abs(k, p))
            torch.cuda.synchronize()
            ok = rel_a <= IAF_RTOL and rel_b <= max(IAF_FP64_FACTOR * rel_p, IAF_RTOL)
            case[inst] = {
                "chain_near_identity": {"max_rel_err": rel_a, "max_abs_err": abs_a},
                "per_transition_model_init_vs_fp64": {
                    "kernel_max_rel_err": rel_b, "plain_fp32_max_rel_err": rel_p,
                    "kernel_vs_plain_max_abs_err": abs_kp},
                "ms": time_ms(torch, lambda: bwd(ys_m, dz, dld, wm), 5), "ok": ok}
            case["ok"] &= ok
            case["max_abs_err"] = max(case.get("max_abs_err", 0.0), abs_a)
            check(ok, f"iaf_chain_bwd ({inst}) disagrees at B={b}: {rel_a}, {rel_b} "
                      f"(plain fp32 {rel_p})")
        case["ms"] = time_ms(torch, lambda: iaf_chain_bwd(ys_m, dz, dld, *wm), 5)
        parts = [p.zero_() for p in bwd_workspace(b, tuple(wm))]
        case["workspace"] = {"clusters": parts[0].shape[0],
                             "bytes": sum(p.numel() * p.element_size() for p in parts),
                             "sum_ms": time_ms(torch, lambda: [p.sum(0) for p in parts], 10)}
        cases.append(case)
        if b == SERVE_BATCH:
            nb = 2
            # per block and transition: the pass, D sweeps, the final VJP and
            # its weight-gradient outer products, each about one MADE pass
            flops = b * nt * nb * (d + 3) * pass_flops()
            out = iaf_chain_bwd(ys_m, dz, dld, *wm)
            bms, by = bound_ms(nbytes(ys_m, dz, dld, *wm, out[0], *out[1]), flops)
            record = with_device_ms(torch, {
                "name": "iaf_chain_bwd", "route": "cuda",
                "source": "rlvae_tpu_torch/csrc/iaf_chain_bwd.cu",
                "replaces": "rlvae_tpu/ops/iaf_kernels.py:585",
                "shape": case["shape"], "ms": case["ms"],
                "plain_ms": time_ms(torch, lambda: iaf_chain_bwd_ref(ys_m, dz, dld, *wm), 2,
                                    warmup=1),
                "bound_ms": bms, "bound_by": by, "library_ms": None,
            }, lambda: iaf_chain_bwd(ys_m, dz, dld, *wm))
    record["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    record["ms_by_batch"] = {c["shape"].split(",")[0]: c["ms"] for c in cases}
    record["ms_streamed_by_batch"] = {c["shape"].split(",")[0]: c["streamed"]["ms"]
                                      for c in cases}
    record["tolerance"] = (f"near-identity chain: |kernel-plain| <= {IAF_RTOL}*scale (dz0 by its "
                           f"largest entry, weight grads per transition); reference init: error "
                           f"vs fp64 <= max({IAF_FP64_FACTOR}x the plain fp32 version's, "
                           f"{IAF_RTOL}) per transition; both instantiations (weights resident, "
                           f"streamed); bit-identical on relaunch")
    return record, cases


def hmc_flops(b: int, k: int, d: int = 16) -> float:
    """FLOP of the HMC terms: per row and centroid, d^2 (3d) and its exp,
    the weighted sum of M (2d^2), the weighted differences (2d) and their
    contraction with M (2d^2); per row, the Cholesky (d^3/3), two
    triangular solves (2d^2) and the logs."""
    return b * (k * (3 * d + 1 + 2 * d * d + 2 * d + 2 * d * d) + d ** 3 / 3 + 2 * d * d + d)


def hmc_cases(torch, dev, batches=HMC_BATCHES):
    """(label, z, centroids, matrices, inv_t2, lbd) for the model's metric,
    the K=200 metric and a K=20 000 bank, at each of ``batches``; the last two
    rows of each batch with B > 1 lie far from every centroid."""
    rng = np.random.default_rng(5)
    for label, c, mats, temp, reg in metric_banks():
        ct, mt = torch.tensor(c, device=dev), torch.tensor(mats, device=dev)
        for b in batches:
            z = c[rng.integers(0, c.shape[0], size=b)] + 0.05 * rng.normal(size=(b, c.shape[1]))
            if b > 1:
                z[-2:] += 100.0
            yield (f"{label},B={b}", torch.tensor(z, dtype=torch.float32, device=dev), ct, mt,
                   1.0 / temp ** 2, reg)


def padded_bank(dev):
    """(label, the seeded K=37 metric, the same padded to 40 as the sharded
    path pads it: far centroids, zero matrices), both on ``dev``."""
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.parallel import pad_metric

    rng = np.random.default_rng(37)
    a = (rng.normal(size=(37, 16, 16)) / 4).astype(np.float32)
    small = CentroidMetric.create(rng.normal(size=(37, 16)),
                                  a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(16), 0.8)
    padded = pad_metric(small, EP_SHARDS)
    on_dev = lambda mt: CentroidMetric(mt.centroids.to(dev), mt.matrices.to(dev),  # noqa: E731
                                       mt.temperature, mt.regularization)
    return "synthetic(K=37 padded to 40)", on_dev(small), on_dev(padded)


def run_hmc_checks(torch, dev):
    """The HMC terms against their plain fp32 version and an fp64 evaluation
    at each bank of :func:`metric_banks` and the padded K=37 bank, B = 1, 37,
    64 and 1000 (every geometry the rule picks there); bit-identical on
    relaunch and in a CUDA-graph replay, the padded bank bit-identical to the
    unpadded one, far rows on the plateau with a zero gradient; each case
    timed with CUDA events and as device time per launch."""
    from rlvae_tpu_torch.ops.metric_kernels import hmc_terms, hmc_terms_ref, launch_hmc_geometry

    log_eps = float(np.log(np.float32(1e-10)))
    label37, small, padded = padded_bank(dev)
    rng = np.random.default_rng(6)
    padded_cases = []
    for b in HMC_KERNEL_BATCHES:
        zn = small.centroids.cpu().numpy()[rng.integers(0, 37, size=b)]
        zn = zn + 0.05 * rng.normal(size=zn.shape)
        if b > 1:
            zn[-2:] += 100.0
        padded_cases.append((f"{label37},B={b}", torch.tensor(zn, dtype=torch.float32, device=dev),
                             padded.centroids, padded.matrices, 1.0 / padded.temperature ** 2,
                             padded.regularization))
    cases, record = [], None
    for label, z, c, m, inv_t2, lbd in [*hmc_cases(torch, dev, HMC_KERNEL_BATCHES),
                                        *padded_cases]:
        args = (inv_t2, lbd, log_eps)
        lp_k, g_k = hmc_terms(z, c, m, *args)
        again = hmc_terms(z, c, m, *args)
        lp_p, g_p = hmc_terms_ref(z, c, m, *args)
        lp_e, g_e = hmc_terms_ref(z.double(), c.double(), m.double(), *args)
        torch.cuda.synchronize()
        g_scale = float(g_e.abs().max().clamp_min(1e-30))
        err = {"kernel_vs_plain": {"log_pi_abs": float((lp_k - lp_p).abs().max()),
                                   "grad_rel": float((g_k - g_p).abs().max()) / g_scale},
               "kernel_vs_fp64": {"log_pi_abs": float((lp_k.double() - lp_e).abs().max()),
                                  "grad_rel": float((g_k.double() - g_e).abs().max()) / g_scale},
               "plain_vs_fp64": {"log_pi_abs": float((lp_p.double() - lp_e).abs().max()),
                                 "grad_rel": float((g_p.double() - g_e).abs().max()) / g_scale}}
        kp, ke, pe = err["kernel_vs_plain"], err["kernel_vs_fp64"], err["plain_vs_fp64"]
        lp_scale = float(lp_e.abs().max())
        ok = (kp["log_pi_abs"] <= HMC_LP_ATOL and kp["grad_rel"] <= HMC_RTOL
              and ke["log_pi_abs"] <= max(IAF_FP64_FACTOR * pe["log_pi_abs"], HMC_RTOL * lp_scale)
              and ke["grad_rel"] <= max(IAF_FP64_FACTOR * pe["grad_rel"], HMC_RTOL))
        same = bool(torch.equal(lp_k, again[0]) and torch.equal(g_k, again[1]))
        if z.shape[0] > 1:  # the far rows: the log 1e-10 plateau and a zero gradient
            ok = ok and bool(torch.all(g_k[-2:] == 0)) and bool(
                torch.all((lp_k[-2:] - log_eps).abs() <= HMC_LP_ATOL))
        if label.startswith(label37):  # the padded centroids add exact zeros
            unpadded = hmc_terms(z, small.centroids, small.matrices, *args)
            same = same and bool(torch.equal(unpadded[0], lp_k) and torch.equal(unpadded[1], g_k))
        b, k = z.shape[0], c.shape[0]
        dms, replayed = device_ms(torch, lambda: hmc_terms(z, c, m, *args))
        graph_same = bool(torch.equal(replayed[0], lp_k) and torch.equal(replayed[1], g_k))
        case = {"shape": label, "ok": ok, **err, "geometry": list(launch_hmc_geometry(b, k, dev)),
                "bit_identical_on_relaunch": same, "bit_identical_in_graph_replay": graph_same,
                "max_abs_err": max(float((lp_k - lp_p).abs().max()),
                                   float((g_k - g_p).abs().max())),
                "ms": time_ms(torch, lambda: hmc_terms(z, c, m, *args), 20), "device_ms": dms}
        case["bound_ms"], case["bound_by"] = bound_ms(nbytes(z, c, m, lp_k, g_k), hmc_flops(b, k))
        cases.append(case)
        check(ok and same and graph_same, f"hmc_terms disagrees at {label}: {case}")
        if label.startswith("metric_T0.7") and label.endswith(f"B={SERVE_BATCH}"):
            record = {
                "name": "hmc_terms", "route": "cuda",
                "source": "rlvae_tpu_torch/csrc/hmc_terms.cu",
                "replaces": "rlvae_tpu/ops/metric_kernels.py:809",
                "shape": label, "ms": case["ms"], "device_ms": dms,
                "plain_ms": time_ms(torch, lambda: hmc_terms_ref(z, c, m, *args), 10),
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"], "library_ms": None,
            }
    record["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    for key in ("ms", "device_ms", "bound_ms"):
        record[f"{key}_by_shape"] = {c["shape"]: c[key] for c in cases}
    record["tolerance"] = (f"kernel vs plain: |log pi| <= {HMC_LP_ATOL}, |grad| <= {HMC_RTOL} of "
                           f"scale; vs fp64: at most {IAF_FP64_FACTOR}x the plain fp32 version's "
                           f"error, or {HMC_RTOL} of scale; far rows on the plateau, grad 0; "
                           f"bit-identical on relaunch and in a CUDA-graph replay; the padded "
                           f"bank bit-identical to the unpadded one")
    return record, cases


def bundle_flops(b: int, k: int, full: bool, d: int = 16) -> float:
    """FLOP of G^{-1} (per row and centroid: d^2 (3d), its exp, the weighted
    sum of M (2d^2); the diagonal) and, for the full bundle, per row the
    Cholesky (d^3/3), X = L^{-1} (d^3/3), G = X^T X (2d^3/3) and the logs."""
    per_row = k * (3 * d + 1 + 2 * d * d) + d
    if full:
        per_row += 4 * d ** 3 / 3 + d
    return b * per_row


def run_bundle_checks(torch, dev):
    """The metric bundle and G^{-1} against their plain fp32 versions and an
    fp64 evaluation, at each bank of :func:`metric_banks` and B=1, 64 and
    1000 (:func:`hmc_cases`' rows: near the centroids, the last two of a
    batch far from all of them).  Each kernel is timed at B=64 for each K."""
    from rlvae_tpu_torch.ops import metric_kernels
    from rlvae_tpu_torch.ops.metric_kernels import (
        g_inv,
        g_inv_ref,
        k_splits,
        metric_bundle,
        metric_bundle_ref,
    )

    names = ("g_inv", "l", "logdet", "g")
    cases = {"metric_bundle": [], "g_inv": []}
    for label, z, c, m, inv_t2, lbd in hmc_cases(torch, dev):
        args = (c, m, inv_t2, lbd)
        got = metric_bundle(z, *args)
        gi_k = g_inv(z, *args)
        plain = metric_bundle_ref(z, *args)
        gi_p = g_inv_ref(z, *args)
        want = metric_bundle_ref(z.double(), c.double(), m.double(), inv_t2, lbd)
        torch.cuda.synchronize()
        err, ok = {}, True
        for name, k_out, p_out, e_out in zip(names, got, plain, want):
            rtol, atol = BUNDLE_TOL[name]
            kp = float((k_out - p_out).abs().max())
            ke = float((k_out.double() - e_out).abs().max())
            pe = float((p_out.double() - e_out).abs().max())
            scale = float(e_out.abs().max())
            ok = ok and bool(torch.all((k_out - p_out).abs() <= atol + rtol * p_out.abs()))
            ok = ok and ke <= max(BUNDLE_FP64_FACTOR * pe, BUNDLE_FP64_RTOL * scale)
            err[name] = {"kernel_vs_plain_abs": kp, "kernel_vs_fp64_abs": ke,
                         "plain_vs_fp64_abs": pe, "fp64_scale": scale}
        ok = (ok and bool(torch.all(torch.triu(got[1], 1) == 0))
              and bool(torch.equal(got[3], got[3].transpose(-1, -2)))
              and bool(torch.equal(gi_k, got[0])))
        gi_err = float((gi_k - gi_p).abs().max())
        ok_gi = bool(torch.all((gi_k - gi_p).abs() <= 1e-6 + 1e-5 * gi_p.abs()))
        check(ok, f"metric_bundle disagrees at {label}: {err}")
        check(ok_gi, f"g_inv disagrees with its plain version at {label}: {gi_err}")
        b, k = z.shape[0], c.shape[0]
        bundle = {"shape": label, "ok": ok, "errors": err,
                  "max_abs_err": max(e["kernel_vs_plain_abs"] for e in err.values())}
        gi_case = {"shape": label, "ok": ok_gi, "max_abs_err": gi_err,
                   "kernel_vs_fp64_abs": float((gi_k.double() - want[0]).abs().max()),
                   "identical_to_bundle_g_inv": True}
        n_splits = k_splits(b, k, dev)
        bundle["n_splits"] = gi_case["n_splits"] = n_splits
        if b == SERVE_BATCH:
            bundle["ms"] = time_ms(torch, lambda: metric_bundle(z, *args), 20)
            bundle["plain_ms"] = time_ms(torch, lambda: metric_bundle_ref(z, *args), 5)
            bundle["bound_ms"], bundle["bound_by"] = bound_ms(
                nbytes(z, c, m, *got), bundle_flops(b, k, True))
            gi_case["ms"] = time_ms(torch, lambda: g_inv(z, *args), 20)
            bundle["device_ms"], _ = device_ms(torch, lambda: metric_bundle(z, *args))
            gi_case["device_ms"], _ = device_ms(torch, lambda: g_inv(z, *args))
            gi_case["plain_ms"] = time_ms(torch, lambda: g_inv_ref(z, *args), 10)
            gi_case["bound_ms"], gi_case["bound_by"] = bound_ms(
                nbytes(z, c, m, gi_k), bundle_flops(b, k, False))
            if n_splits > 1:  # the same launch with the bank in one range, for comparison
                own_splits = metric_kernels.k_splits
                metric_kernels.k_splits = lambda b, k, device: 1
                try:
                    bundle["ms_one_split"] = time_ms(torch, lambda: metric_bundle(z, *args), 20)
                    gi_case["ms_one_split"] = time_ms(torch, lambda: g_inv(z, *args), 20)
                finally:
                    metric_kernels.k_splits = own_splits
        cases["metric_bundle"].append(bundle)
        cases["g_inv"].append(gi_case)

    def record(name, source, replaces, main):
        timed = [c for c in cases[name] if "ms" in c]
        rec = next(c for c in timed if c["shape"].startswith(main))
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": rec["shape"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
            "device_ms": rec["device_ms"],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms_by_shape": {c["shape"]: c["ms"] for c in timed},
            "device_ms_by_shape": {c["shape"]: c["device_ms"] for c in timed},
            "ms_one_split_by_shape": {c["shape"]: c["ms_one_split"] for c in timed
                                      if "ms_one_split" in c},
            "plain_ms_by_shape": {c["shape"]: c["plain_ms"] for c in timed},
            "bound_ms_by_shape": {c["shape"]: c["bound_ms"] for c in timed},
        }

    tol = (f"kernel vs plain: |err| <= atol + rtol*|plain| with (rtol, atol) {BUNDLE_TOL}; vs "
           f"fp64: each output's error at most {BUNDLE_FP64_FACTOR}x the plain fp32 version's, or "
           f"{BUNDLE_FP64_RTOL} of its scale; L upper triangle 0, G bitwise symmetric")
    # the main path's banks: the hybrid model's K=200 metric (the geodesic
    # posterior's G) and the default model's K=50 metric (its evaluation step)
    bundle_rec = record("metric_bundle", "rlvae_tpu_torch/csrc/metric_bundle.cu",
                        "rlvae_tpu/ops/metric_kernels.py:657", "metric.npz")
    bundle_rec["tolerance"] = tol
    gi_rec = record("g_inv", "rlvae_tpu_torch/csrc/metric_bundle.cu",
                    "rlvae_tpu/ops/metric_kernels.py:618", "metric_T0.7")
    gi_rec["tolerance"] = (f"kernel vs plain: |err| <= 1e-6 + 1e-5*|plain|; bitwise equal to the "
                           f"metric bundle's G^-1 output")
    return {"metric_bundle": (bundle_rec, cases["metric_bundle"]),
            "g_inv": (gi_rec, cases["g_inv"])}


def partials_flops(b: int, k: int, d: int = 16) -> float:
    """FLOP of the HMC partials: per row and centroid, d^2 (3d), the
    weighted sum of M (2d^2), the weighted differences (2d) and their
    contraction with M (2d^2); 1104 at d=16."""
    return b * k * (3 * d + 2 * d * d + 2 * d + 2 * d * d)


def partials_banks(torch, dev):
    """(label, centroids, matrices, inv_t2) on ``dev``: the banks of
    :func:`metric_banks` and the padded K=37 bank of :func:`padded_bank`."""
    out = [(label, torch.tensor(c, device=dev), torch.tensor(m, device=dev), 1.0 / t ** 2)
           for label, c, m, t, _ in metric_banks()]
    label37, _, padded = padded_bank(dev)
    out.append((label37, padded.centroids, padded.matrices, 1.0 / padded.temperature ** 2))
    return out


def run_partials_checks(torch, dev):
    """The HMC partials against their plain fp32 version and an fp64
    evaluation at each bank of :func:`partials_banks` and B = 64, 37, 1 and
    1000 (the last two rows of a batch far from every centroid);
    bit-identical on relaunch and in a CUDA-graph replay; device time per
    launch of every case, CUDA-event time of each bank at B=64."""
    from rlvae_tpu_torch.ops.metric_kernels import (
        hmc_partials,
        hmc_partials_ref,
        launch_hmc_geometry,
    )

    rng = np.random.default_rng(8)
    cases = []
    for label, c, m, inv_t2 in partials_banks(torch, dev):
        k_real = 37 if "padded" in label else c.shape[0]
        for b in PARTIALS_BATCHES:
            zn = c[:k_real].cpu().numpy()[rng.integers(0, k_real, size=b)]
            zn = zn + 0.05 * rng.normal(size=zn.shape)
            if b > 1:
                zn[-2:] += 100.0
            z = torch.tensor(zn, dtype=torch.float32, device=dev)
            got = hmc_partials(z, c, m, inv_t2)
            again = hmc_partials(z, c, m, inv_t2)
            plain = hmc_partials_ref(z, c, m, inv_t2)
            want = hmc_partials_ref(z.double(), c.double(), m.double(), inv_t2)
            torch.cuda.synchronize()
            err, ok = {}, True
            for name, k_out, rerun, p_out, e_out in zip(("gi_part", "v"), got, again, plain, want):
                ke = float((k_out.double() - e_out).abs().max())
                pe = float((p_out.double() - e_out).abs().max())
                scale = float(e_out.abs().max())
                ok = (ok and bool(torch.equal(k_out, rerun))
                      and bool(torch.all((k_out - p_out).abs()
                                         <= PARTIALS_TOL[name] * p_out.abs().clamp_min(1.0)))
                      and ke <= max(IAF_FP64_FACTOR * pe, PARTIALS_FP64_RTOL * scale))
                err[name] = {"kernel_vs_plain_abs": float((k_out - p_out).abs().max()),
                             "kernel_vs_fp64_abs": ke, "plain_vs_fp64_abs": pe,
                             "fp64_scale": scale}
            if b > 1:  # the far rows: every weight underflows
                ok = ok and bool(torch.all(got[0][-2:] == 0) and torch.all(got[1][-2:] == 0))
            if "padded" in label:  # the padded centroids add exact zeros
                unpadded = hmc_partials(z, c[:37].contiguous(), m[:37].contiguous(), inv_t2)
                ok = (ok and bool(torch.equal(unpadded[0], got[0]))
                      and bool(torch.equal(unpadded[1], got[1])))
            dms, replayed = device_ms(torch, lambda: hmc_partials(z, c, m, inv_t2))
            ok = ok and bool(torch.equal(replayed[0], got[0]) and torch.equal(replayed[1], got[1]))
            shape = f"{label},B={b}"
            check(ok, f"hmc_partials disagrees at {shape}: {err}")
            case = {"shape": shape, "ok": ok, "errors": err, "bit_identical_on_relaunch": True,
                    "bit_identical_in_graph_replay": True,
                    "geometry": list(launch_hmc_geometry(b, c.shape[0], dev)),
                    "device_ms": dms,
                    "max_abs_err": max(e["kernel_vs_plain_abs"] for e in err.values())}
            if b == SERVE_BATCH:
                case["ms"] = time_ms(torch, lambda: hmc_partials(z, c, m, inv_t2), 20)
                case["plain_ms"] = time_ms(torch, lambda: hmc_partials_ref(z, c, m, inv_t2), 10)
                case["bound_ms"], case["bound_by"] = bound_ms(
                    nbytes(z, c, m, *got), partials_flops(b, c.shape[0]))
            cases.append(case)
    timed = [c for c in cases if "ms" in c]
    main = next(c for c in timed if c["shape"].startswith("metric_T0.7"))
    record = {
        "name": "hmc_partials", "route": "cuda",
        "source": "rlvae_tpu_torch/csrc/hmc_partials.cu",
        "replaces": "rlvae_tpu/ops/metric_kernels.py:886",
        "shape": main["shape"], "ms": main["ms"], "plain_ms": main["plain_ms"],
        "device_ms": main["device_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms_by_shape": {c["shape"]: c["ms"] for c in timed},
        "device_ms_by_shape": {c["shape"]: c["device_ms"] for c in cases},
        "plain_ms_by_shape": {c["shape"]: c["plain_ms"] for c in timed},
        "bound_ms_by_shape": {c["shape"]: c["bound_ms"] for c in timed},
        "tolerance": (f"kernel vs plain: |err| <= {PARTIALS_TOL} * max(1, |plain|); vs fp64: "
                      f"at most {IAF_FP64_FACTOR}x the plain fp32 version's error, or "
                      f"{PARTIALS_FP64_RTOL} of scale; bit-identical on relaunch and in a "
                      f"CUDA-graph replay; far rows 0; the padded bank bit-identical to the "
                      f"unpadded one"),
    }
    return record, cases


def pretrained_decoder(dev):
    """The fast preset's decoder with the pretrained weights, on ``dev``."""
    from rlvae_tpu_torch.convert import load_pretrained_net
    from rlvae_tpu_torch.nets.registry import create_decoder

    dec = create_decoder((3, 64, 64), 16, {"architecture": "mlp", "out_dtype": "bfloat16"})
    load_pretrained_net(dec, PRETRAINED / "decoder.npz")
    return dec.to(dev).requires_grad_(False)


def decode_inputs(torch, dec, m: int, n: int, seed: int):
    """(h, W, b, x, rw) as the fast train step gives them to decode+MSE: h the
    decoder's hidden layer (bf16) at latents drawn from N(0, I), W [N, 512]
    and b its output layer (the first N units), x targets in [0, 1], rw = 1/B
    with rows 3 and 4 at 0 (a masked frame)."""
    dev = dec.out.weight.device
    rng = np.random.default_rng(seed)
    z = torch.tensor(rng.normal(size=(m, 16)), dtype=torch.float32, device=dev)
    rw = np.full((m,), 1.0 / TRAIN_BATCH, np.float32)
    rw[3:5] = 0.0
    return (dec.hidden(z), dec.out.weight[:n].contiguous(), dec.out.bias[:n].contiguous(),
            torch.tensor(rng.uniform(size=(m, n)), dtype=torch.float32, device=dev),
            torch.tensor(rw, device=dev))


def run_decode_checks(torch, dev):
    """decode+MSE's three entry points against their plain versions (the
    loss also against fp64) at DECODE_ROWS x DECODE_COLS, bit-identical on a
    second launch and in a CUDA-graph replay; each timed at DECODE_TIMED_ROWS
    x 12288, warm and cold."""
    from rlvae_tpu_torch.ops import recon_kernels
    from rlvae_tpu_torch.ops.recon_kernels import (
        decode_mse,
        decode_mse_bwd_dh,
        decode_mse_bwd_dw,
        decode_mse_dh_ref,
        decode_mse_dw_ref,
        decode_mse_ref,
    )

    names = ("decode_mse_fwd", "decode_mse_bwd_dh", "decode_mse_bwd_dw")
    cases = {name: [] for name in names}
    g = torch.ones((), device=dev)
    dec = pretrained_decoder(dev)
    for m in DECODE_ROWS:
        for n in DECODE_COLS:
            h, w, b, x, rw = decode_inputs(torch, dec, m, n, seed=m + n)
            args = (h, w, b, x, rw)
            loss = decode_mse(*args)
            dh = decode_mse_bwd_dh(*args, g)
            dw, db = decode_mse_bwd_dw(*args, g)
            ref = decode_mse_ref(*args)
            ref64 = decode_mse_ref(h, w.double(), b.double(), x.double(), rw.double())
            dh_p = decode_mse_dh_ref(*args, g)
            dw_p, db_p = decode_mse_dw_ref(*args, g)
            dw2, db2 = decode_mse_bwd_dw(*args, g)
            same = (torch.equal(loss, decode_mse(*args))
                    and torch.equal(dh, decode_mse_bwd_dh(*args, g))
                    and torch.equal(dw, dw2) and torch.equal(db, db2))
            replayed = graph_replay_equal(
                torch, lambda: (decode_mse(*args), decode_mse_bwd_dh(*args, g),
                                *decode_mse_bwd_dw(*args, g)), (loss, dh, dw, db))
            torch.cuda.synchronize()
            shape = f"M={m},K=512,N={n}"
            err_k, err_p = abs(float(loss) - float(ref64)), abs(float(ref) - float(ref64))
            fwd_ok = (abs(float(loss) - float(ref)) <= DECODE_LOSS_RTOL * abs(float(ref))
                      and err_k <= max(DECODE_FP64_FACTOR * err_p,
                                       DECODE_FP64_RTOL * abs(float(ref64))))
            cases["decode_mse_fwd"].append({
                "shape": shape, "ok": fwd_ok, "loss": float(loss),
                "max_abs_err": abs(float(loss) - float(ref)),
                "kernel_vs_fp64_abs": err_k, "plain_vs_fp64_abs": err_p})

            def grad_case(got, want):
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                differ = int((got != want).sum())
                return {"shape": shape, "ok": err <= DECODE_GRAD_RTOL * scale, "max_abs_err": err,
                        "scale": scale, "elements_differing": differ, "elements": got.numel()}

            h32 = h.float()
            dh_case = grad_case(decode_mse_bwd_dh(h32, w, b, x, rw, g),
                                decode_mse_dh_ref(h32, w, b, x, rw, g))
            d, ref_abs = (dh.float() - dh_p.float()).abs(), dh_p.float().abs()
            bf16_ok = bool(torch.all(d <= 2.0 ** -7 * ref_abs
                                     + DECODE_GRAD_RTOL * float(ref_abs.max())))
            dh_case["bf16_dh"] = {"max_abs_err": float(d.max()), "ok": bf16_ok,
                                  "elements_differing": int((dh != dh_p).sum())}
            dh_case["ok"] = dh_case["ok"] and bf16_ok
            dh_case["masked_rows_zero"] = bool(torch.all(dh[3:5] == 0))
            cases["decode_mse_bwd_dh"].append(dh_case)
            dw_case, db_case = grad_case(dw, dw_p), grad_case(db, db_p)
            dw_case["db"] = db_case
            dw_case["ok"] = dw_case["ok"] and db_case["ok"]
            dw_case["max_abs_err"] = max(dw_case["max_abs_err"], db_case["max_abs_err"])
            cases["decode_mse_bwd_dw"].append(dw_case)
            for name in names:
                cases[name][-1]["bit_identical_on_relaunch"] = same
                cases[name][-1]["bit_identical_in_graph_replay"] = replayed
                check(cases[name][-1]["ok"] and same and replayed
                      and cases["decode_mse_bwd_dh"][-1]["masked_rows_zero"],
                      f"{name} disagrees at {shape}: {cases[name][-1]}")

    # timing at the fast train step's rows and a larger batch, N = 12288:
    # warm (a replayed graph, W and x in L2 where they fit) and cold (each
    # launch after an L2-evicting write, that write's time subtracted)
    timed = {name: {} for name in names}
    flush = torch.empty(DECODE_FLUSH_BYTES // 4, device=dev)
    for m in DECODE_TIMED_ROWS:
        h, w, b, x, rw = args = decode_inputs(torch, dec, m, DECODE_COLS[0], seed=m)
        shape, mkn = f"M={m},K=512,N={DECODE_COLS[0]}", 2.0 * m * 512 * DECODE_COLS[0]
        ins = nbytes(h, w, b, x, rw)
        w_bf16 = w.to(torch.bfloat16)
        dp_bf16 = recon_kernels._dp(h, w, b, x, rw, torch.float32).to(torch.bfloat16)
        products = {  # cuBLAS's bf16 product alone, each entry point's last product
            "decode_mse_fwd": lambda: torch.matmul(h, w_bf16.t()),
            "decode_mse_bwd_dh": lambda: torch.matmul(dp_bf16, w_bf16),
            "decode_mse_bwd_dw": lambda: torch.matmul(dp_bf16.t(), h),
        }
        runs = {
            # (kernel, plain version, bytes of its inputs and outputs, operations)
            "decode_mse_fwd": (lambda: decode_mse(*args), lambda: decode_mse_ref(*args),
                               ins + 4, mkn),
            "decode_mse_bwd_dh": (lambda: decode_mse_bwd_dh(*args, g),
                                  lambda: decode_mse_dh_ref(*args, g),
                                  ins + 4 + nbytes(h), 2 * mkn),
            "decode_mse_bwd_dw": (lambda: decode_mse_bwd_dw(*args, g),
                                  lambda: decode_mse_dw_ref(*args, g),
                                  ins + 4 + nbytes(w, b), 2 * mkn),
        }
        for name, (kernel, plain, n_bytes, n_ops) in runs.items():
            bms, by = bound_ms(n_bytes, n_ops, PEAK_BF16_TENSOR_FLOPS)
            timed[name][shape] = {"ms": time_ms(torch, kernel, 10),
                                  "device_ms": device_ms(torch, kernel)[0],
                                  "cold_ms": cold_device_ms(torch, kernel, flush),
                                  "plain_ms": time_ms(torch, plain, 5),
                                  "bound_ms": bms, "bound_by": by,
                                  "cublas_bf16_product_ms": device_ms(torch, products[name])[0]}
    del flush

    main_shape = f"M={DECODE_TIMED_ROWS[0]},K=512,N={DECODE_COLS[0]}"
    lines = {"decode_mse_fwd": 167, "decode_mse_bwd_dh": 183, "decode_mse_bwd_dw": 192}
    tol = (f"kernel vs plain: loss rtol {DECODE_LOSS_RTOL}, each gradient within "
           f"{DECODE_GRAD_RTOL} of its largest entry (dh as its fp32 sum), the bf16 dh within one "
           f"bf16 step (2^-7) of each element plus that; loss vs fp64 at most "
           f"{DECODE_FP64_FACTOR}x "
           f"the plain fp32 version's error, or {DECODE_FP64_RTOL} relative; rows with rw=0 give "
           f"exact zeros in dh; bit-identical on relaunch and in a CUDA-graph replay")
    out = {}
    for name in names:
        t = timed[name][main_shape]
        out[name] = ({
            "name": name, "route": "cuda", "source": "rlvae_tpu_torch/csrc/decode_mse.cu",
            "replaces": f"rlvae_tpu/ops/recon_kernels.py:{lines[name]}",
            "shape": main_shape, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "device_ms": t["device_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_peaks": "products at the bf16 tensor-core peak (989 TFLOP/s), "
                           "bytes at 3.35 TB/s",
            "library_ms": None,
            "cold_ms": t["cold_ms"],
            "cublas_bf16_product_ms": t["cublas_bf16_product_ms"],
            "cublas_bf16_product": "device ms of torch.matmul in bf16 of the entry point's last "
                                   "product alone (forward [M,512]x[512,N], dh [M,N]x[N,512], "
                                   "dW [N,M]x[M,512]); no PyTorch call computes decode+MSE",
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms_by_shape": {k: v["ms"] for k, v in timed[name].items()},
            "device_ms_by_shape": {k: v["device_ms"] for k, v in timed[name].items()},
            "cold_ms_by_shape": {k: v["cold_ms"] for k, v in timed[name].items()},
            "plain_ms_by_shape": {k: v["plain_ms"] for k, v in timed[name].items()},
            "bound_ms_by_shape": {k: v["bound_ms"] for k, v in timed[name].items()},
            "cublas_bf16_product_ms_by_shape": {k: v["cublas_bf16_product_ms"]
                                                for k, v in timed[name].items()},
            "tolerance": tol,
        }, cases[name])
    return out


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


def run_serve(torch):
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig

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
        zero_launch_counts()
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
        launches = launch_counts()
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
    check(all(launches[k] == 0 for k in ("iaf_chain_bwd", "hmc_terms", "metric_bundle", "g_inv")),
          f"reconstruct launched the backward, the HMC terms or a metric-bundle kernel: "
          f"{launches}")

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
            "forward_b64": profile_forward(torch, manager, x, {"eps": eps.to(manager.device)}),
            "generate_official": serve_generate(torch, manager)}


# A row of a batched generate against the same seed generated alone on the
# card: the draws and the chain are per row, but the decoder's bf16 products
# at another batch size may round apart (a bf16 step is 2^-8 relative).
GEN_ROW_TOL = {"mean_abs": 1e-4, "max_abs": 2e-2}


def serve_generate(torch, manager):
    """The engine's ``generate`` op with the official chain: concurrent seeds
    coalesced into one bucket, and a lone request padded to it."""
    from rlvae_tpu_torch import BatchingEngine, ServeConfig

    bucket = len(SERVE_SEEDS)
    single = {s: manager.sample_random(1, "official", seed=s)[0] for s in set(SERVE_SEEDS)}
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(bucket,), max_wait_ms=2000),
                                         generate_method="official")
    try:
        t0 = time.perf_counter()
        futs = [engine.submit("generate", np.uint32(s)) for s in SERVE_SEEDS]
        rows = [f.result(timeout=120) for f in futs]
        batch_s = time.perf_counter() - t0
        batches = engine.stats_snapshot()["batches"]
        lone = engine.run("generate", np.uint32(SERVE_SEEDS[1]), timeout=120)
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
    check(batches == 1, f"the {bucket} generate requests took {batches} dispatches")
    check(np.array_equal(rows[0], rows[2]), "the duplicate seeds' rows differ in one batch")
    errs = []
    for s, row in list(zip(SERVE_SEEDS, rows)) + [(SERVE_SEEDS[1], lone)]:
        check(row.shape == (8, 3, 64, 64) and np.isfinite(row).all(), "bad generate row")
        d = np.abs(row - single[s])
        errs.append({"seed": s, "mean_abs": float(d.mean()), "max_abs": float(d.max())})
        check(errs[-1]["mean_abs"] <= GEN_ROW_TOL["mean_abs"]
              and errs[-1]["max_abs"] <= GEN_ROW_TOL["max_abs"],
              f"generate row of seed {s} differs from sample_random(1, seed): {errs[-1]}")
    return {"seeds": list(SERVE_SEEDS), "batch_s": batch_s, "rows_vs_single": errs,
            "tolerance": GEN_ROW_TOL, "duplicate_rows_bit_identical": True,
            "stats": {k: v for k, v in stats.items() if not k.endswith("_hist")}}


def profile_forward(torch, manager, x, noise):
    """Warm B=64 forward: ms from CUDA events (device-side, inputs already
    on the card), ``reconstruct`` ms on the host clock (upload and copy-back
    included), and one profiled forward's device time by kernel."""
    xd = torch.from_numpy(x).to(manager.device)
    fwd_ms = time_ms(torch, lambda: manager.forward(xd, noise=noise), 5)
    host = []
    for _ in range(5):
        t = time.perf_counter()
        manager.reconstruct(x)
        host.append((time.perf_counter() - t) * 1e3)
    busy_ms, kernels = device_time_by_kernel(torch, lambda: manager.forward(xd, noise=noise))
    return {"forward_ms": fwd_ms, "reconstruct_host_ms_median": float(np.median(host)),
            "profiled_device_busy_ms": busy_ms, "n_kernel_names": len(kernels),
            "top_kernels": kernels[:10]}


def device_time_by_kernel(torch, fn):
    """One profiled call of ``fn``: (device-busy ms, [{name, us, calls}] by
    kernel, largest first), from ``torch.profiler``'s self device times."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0 and "cuda" in str(getattr(evt, "device_type", "")).lower():
            kernels.append({"name": evt.key[:80], "us": float(us), "calls": int(evt.count)})
    kernels.sort(key=lambda k: -k["us"])
    return sum(k["us"] for k in kernels) / 1e3, kernels


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


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

# Card step vs the same step replayed on the CPU from the card's weights and
# optimizer state just before it.  The nets run bf16 activations, which the
# two devices round at other places (2^-8 relative per rounding), and the
# reference-init flows scale the latent ~20x per transition, so gradients
# are compared relative to each tensor's largest entry.
TRAIN_TOL = {
    "loss_rel": 1e-3,       # loss, recon_loss, kld_loss, flow_loss, every step
    # the nets' weight gradients come out of bf16 products: one bf16 step is
    # 2^-8 = 3.9e-3 relative, and the two devices round some entries a step
    # or two apart
    "grad_norm_rel": 2e-2,  # every step
    "grad_rel": 2e-2,       # step 1, each parameter's gradient vs its largest entry
}


def _wrappers():
    from rlvae_tpu_torch.ops.iaf_kernels import iaf_chain_bwd, iaf_chain_fwd
    from rlvae_tpu_torch.ops.metric_kernels import (
        chol_bundle,
        g_inv,
        hmc_partials,
        hmc_terms,
        metric_bundle,
    )
    from rlvae_tpu_torch.ops.recon_kernels import decode_mse, decode_mse_bwd_dh, decode_mse_bwd_dw

    return {"chol_bundle": chol_bundle, "iaf_chain_fwd": iaf_chain_fwd,
            "iaf_chain_bwd": iaf_chain_bwd, "hmc_terms": hmc_terms,
            "metric_bundle": metric_bundle, "g_inv": g_inv, "decode_mse_fwd": decode_mse,
            "decode_mse_bwd_dh": decode_mse_bwd_dh, "decode_mse_bwd_dw": decode_mse_bwd_dw,
            "hmc_partials": hmc_partials}


def launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def zero_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def expected_launches(**nonzero):
    """A full launch-count dict: the named counts, every other kernel 0."""
    return {**{name: 0 for name in _wrappers()}, **nonzero}


def run_train(torch, model_config=None, steps: int = TRAIN_STEPS, per_step=None, dev=None):
    """``steps`` Trainer steps of ``model_config`` (the default preset) at
    B=16 with one validation pass; ``per_step`` is the launch count every
    step must show (the default model's: chol-bundle 2, IAF-chain forward
    and backward 1 each)."""
    from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
    from rlvae_tpu_torch.models import PRESETS, create_model
    from rlvae_tpu_torch.train import TRAINING_PRESETS, Trainer, make_optimizer, make_train_step

    model_config = model_config or PRESETS["riemannian_flow_vae"]
    per_step = per_step or expected_launches(chol_bundle=2, iaf_chain_fwd=1, iaf_chain_bwd=1)
    cfg = copy.deepcopy(TRAINING_PRESETS["default"])
    cfg["data"]["batch_size"] = TRAIN_BATCH
    cfg["n_train_samples"], cfg["n_val_samples"] = steps * TRAIN_BATCH, TRAIN_BATCH
    t0 = time.perf_counter()
    data = CyclicDataModule({**CYCLIC_SPRITES, "synthetic_n_test": TRAIN_BATCH}, seed=0)
    data.setup(cfg)
    model = create_model(model_config, seed=0)
    trainer = Trainer(model, data, cfg, seed=0, device=dev)
    check(dev is not None or trainer.device.type == "cuda", f"trainer on {trainer.device}")
    setup_s = time.perf_counter() - t0

    # record every step: the weights and optimizer state before it, its
    # inputs, metrics and kernel launches, and step 1's gradients
    records, step = [], trainer.train_step

    def recorded_step(x, noise):
        rec = {"state": {k: v.detach().clone() for k, v in model.state_dict().items()},
               "opt": copy.deepcopy(trainer.optimizer.state_dict()), "x": x.cpu(),
               "noise": {k: v.cpu() for k, v in noise.items()}}
        before = launch_counts()
        metrics = step(x, noise)
        rec["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
        rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        if not records:
            rec["grads"] = [p.grad.detach().cpu().clone() for p in model.parameters()]
        records.append(rec)
        return metrics

    trainer.train_step = recorded_step
    torch.cuda.synchronize()
    zero_launch_counts()
    t_fit = time.perf_counter()
    result = trainer.fit(max_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = launch_counts()
    trainer.train_step = step
    check(result["steps"] == steps == len(records), f"ran {result['steps']} steps")
    for i, rec in enumerate(records):
        check(rec["launches"] == per_step, f"step {i + 1} launched {rec['launches']}")
        check(all(np.isfinite(v) for v in rec["metrics"].values()), f"step {i + 1} not finite")
    validation = result["history"][-1]
    check(all(np.isfinite(v) for v in validation.values()), "non-finite validation")
    check(all(f"val/{k}" in validation for k in EVAL_METRIC_KEYS),
          f"validation lacks analysis metrics: {sorted(validation)}")
    # the validation pass alone launches G^{-1} (the analysis metrics at z0)
    check(launches["g_inv"] == len(result["history"]),
          f"{launches['g_inv']} G^-1 launches in {len(result['history'])} validation passes")

    # the same steps on the CPU, each from the card's state just before it
    cpu_model = create_model(model_config, seed=0)
    opt_cfg = cfg["optimizer"]
    cpu_opt = make_optimizer(cpu_model.parameters(), opt_cfg["lr"], opt_cfg["weight_decay"])
    cpu_step = make_train_step(cpu_model, cpu_opt)
    errors = []
    for i, rec in enumerate(records):
        cpu_model.load_state_dict(rec["state"])
        cpu_opt.load_state_dict(rec["opt"])
        m = {k: float(v) for k, v in cpu_step(rec["x"], rec["noise"]).items()}
        err = {k: abs(rec["metrics"][k] - m[k]) / max(abs(m[k]), 1e-12)
               for k in ("loss", "recon_loss", "kld_loss", "flow_loss", "grad_norm")}
        err["loop_penalty_abs"] = abs(rec["metrics"]["loop_penalty"] - m["loop_penalty"])
        if i == 0:
            err["grad_rel"] = max(
                float((g - p.grad).abs().max() / p.grad.abs().max().clamp_min(1e-30))
                for g, p in zip(rec["grads"], cpu_model.parameters()))
        errors.append(err)
        for k in ("loss", "recon_loss", "kld_loss", "flow_loss"):
            check(err[k] <= TRAIN_TOL["loss_rel"], f"step {i + 1} {k}: card vs CPU {err[k]}")
        check(err["grad_norm"] <= TRAIN_TOL["grad_norm_rel"],
              f"step {i + 1} grad_norm: card vs CPU {err['grad_norm']}")
        check(err["loop_penalty_abs"] <= 1e-6, f"step {i + 1} loop_penalty differs")
    check(errors[0]["grad_rel"] <= TRAIN_TOL["grad_rel"],
          f"step-1 gradients: card vs CPU {errors[0]['grad_rel']}")

    # one warm step, timed and profiled
    x = records[-1]["x"].to(trainer.device)
    noise = {k: v.to(trainer.device) for k, v in records[-1]["noise"].items()}
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, lambda: step(x, noise), 5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # before the profile: a profiler session leaves launches slower after it
    phases = step_phases(torch, model, trainer.optimizer, x, noise)
    busy_ms, kernels = device_time_by_kernel(torch, lambda: step(x, noise))
    return {
        "model": model.name, "steps": result["steps"], "batch": TRAIN_BATCH,
        "device_busy_share": busy_ms / step_ms,
        "setup_s": setup_s, "fit_s": fit_s,
        "launches": launches, "launches_per_step": records[0]["launches"],
        "losses": [r["metrics"]["loss"] for r in records],
        "validation": {k: v for k, v in validation.items() if k.startswith("val/")},
        "card_vs_cpu": {"errors": errors, "tolerances": TRAIN_TOL},
        "step_ms": step_ms, "peak_memory_gb": peak_gb,
        "profiled_device_busy_ms": busy_ms, "n_kernel_names": len(kernels),
        "n_kernel_launches": sum(k["calls"] for k in kernels), "phases": phases,
        "top_kernels": kernels[:12],
    }


def step_phases(torch, model, optimizer, x, noise, reps: int = 3):
    """The parts of one train step (the body of ``make_train_step``, spelled
    out): mean ms on CUDA events and on the host clock (no synchronisation
    inside the step, so a host time close to the device time means the
    part is bound by the host's launches)."""
    names = ("forward", "backward", "grad_fill_and_norm", "adam")
    dev = {n: 0.0 for n in names}
    host = {n: 0.0 for n in names}
    params = [p for p in model.parameters() if p.requires_grad]
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        t = [0.0] * (len(names) + 1)
        torch.cuda.synchronize()
        t[0] = time.perf_counter()
        ev[0].record()
        optimizer.zero_grad(set_to_none=True)
        out = model(x, noise, train=True)
        ev[1].record()
        t[1] = time.perf_counter()
        out.loss.backward()
        ev[2].record()
        t[2] = time.perf_counter()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
        ev[3].record()
        t[3] = time.perf_counter()
        optimizer.step()
        ev[4].record()
        t[4] = time.perf_counter()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            dev[n] += ev[i].elapsed_time(ev[i + 1]) / reps
            host[n] += (t[i + 1] - t[i]) * 1e3 / reps
    return {"device_ms": dev, "host_ms": host}


# ---------------------------------------------------------------------------
# generate phase
# ---------------------------------------------------------------------------

# launches per call of sample_random_batched_seeds, by method, besides one
# IAF-chain launch each: the geodesic and centroid-aware priors take G^{-1}
# for their eigh square root; the weighted mixture runs the chol-bundle for L
# and for its logdet; basic runs 10 gradient steps through the logdet's
# Function; the chains launch the HMC terms)
GEN_LAUNCHES = {
    "geodesic": {"g_inv": 1},
    "centroid_aware": {"g_inv": 1},
    "weighted_mixture": {"chol_bundle": 2},
    "basic": {"chol_bundle": 10},
    "official": {"hmc_terms": CHAIN_LAUNCHES},
    "hmc": {"hmc_terms": CHAIN_LAUNCHES},
}


def generate_calls():
    """(method, batch) of the generate phase's main run."""
    calls = [(m, b) for m in ("geodesic", "official") for b in GEN_BATCHES]
    return calls + [(m, GEN_BATCHES[-1]) for m in ("centroid_aware", "weighted_mixture", "basic",
                                                   "hmc")]


def run_generate(torch, dev=None):
    from rlvae_tpu_torch import ModelManager, PRESETS

    t0 = time.perf_counter()
    manager = ModelManager.from_config(PRESETS["riemannian_flow_vae"], seed=0, device=dev)
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    load_s = time.perf_counter() - t0
    manager.sample_random_batched_seeds([0], method="official")  # warm-up
    torch.cuda.synchronize()

    calls = []
    zero_launch_counts()
    for i, (method, b) in enumerate(generate_calls()):
        seeds = list(range(100 * i, 100 * i + b))
        before = launch_counts()
        t = time.perf_counter()
        x = manager.sample_random_batched_seeds(seeds, method=method)
        host_s = time.perf_counter() - t
        got = {k: v - before[k] for k, v in launch_counts().items()}
        want = expected_launches(**GEN_LAUNCHES[method], iaf_chain_fwd=1)
        check(got == want, f"generate {method} B={b} launched {got}, expected {want}")
        check(x.shape == (b, 8, 3, 64, 64) and np.isfinite(x).all()
              and x.min() >= 0.0 and x.max() <= 1.0, f"bad generate output {method} B={b}")
        calls.append({"method": method, "batch": b, "host_ms": host_s * 1e3, "launches": got})
    launches = launch_counts()

    # one official call at B=64: host time and the profiled device time
    seeds = list(range(GEN_BATCHES[-1]))
    busy_ms, kernels = device_time_by_kernel(
        torch, lambda: manager.sample_random_batched_seeds(seeds, method="official"))
    return {
        "load_s": load_s, "calls": calls, "launches": launches,
        "official_b64": {"profiled_device_busy_ms": busy_ms, "n_kernel_names": len(kernels),
                         "n_kernel_launches": sum(k["calls"] for k in kernels),
                         "top_kernels": kernels[:10]},
        "chain_card_vs_cpu": replay_chain(torch, manager),
        "geodesic_card_vs_cpu": compare_geodesic(torch, manager),
    }


def replay_chain(torch, manager):
    """The official chain at B=64 on the card, one MCMC step at a time, each
    step replayed on the CPU (plain terms) from the card's state before it
    with the same momenta and uniforms."""
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.samplers import HMCConfig, mcmc_step, run_prior_chain
    from rlvae_tpu_torch.samplers.hmc import _terms_fn

    b = GEN_BATCHES[-1]
    metric = manager.model.metric
    cpu_metric = CentroidMetric(metric.centroids.cpu(), metric.matrices.cpu(),
                                metric.temperature, metric.regularization)
    cfg = HMCConfig()
    gen = torch.Generator(device=manager.device).manual_seed(17)
    noise = manager.model.draw_generation_noise(b, "official", gen)
    terms, cpu_terms = _terms_fn(metric), _terms_fn(cpu_metric)
    with torch.no_grad():
        z_ref = run_prior_chain(terms, noise["z0"], noise["gammas"], noise["unifs"], cfg)[0]
        log_pi, grad = terms(noise["z0"])
        state = (noise["z0"], log_pi, -grad, np.float32(1.0))
        stats, accepted = _step_stats(), 0
        for step in range(cfg.mcmc_steps):
            gamma, u = noise["gammas"][step], noise["unifs"][step]
            nxt, acc, alpha = mcmc_step(terms, state, gamma, u, cfg)
            cpu_state = tuple(t.cpu() for t in state[:3]) + (state[3],)
            c_nxt, c_acc, _ = mcmc_step(cpu_terms, cpu_state, gamma.cpu(), u.cpu(), cfg)
            _compare_step(stats, acc.cpu(), alpha.cpu(), u.cpu(), nxt[0].cpu(), c_acc, c_nxt[0])
            accepted += int(acc.sum())
            state = nxt
        check(torch.equal(state[0], z_ref), "the stepped chain differs from run_prior_chain")
    check(stats["flips_outside_margin"] == 0,
          f"card and CPU accept decisions differ on {stats['flips_outside_margin']} non-tie rows")
    check(stats["max_z_rel_err"] <= CHAIN_Z_RTOL,
          f"card chain vs CPU replay: z differs by {stats['max_z_rel_err']} of scale")
    check(accepted > 0, "the official chain accepted nothing")
    return {"batch": b, "accepted": accepted, "accept_rate": accepted / (b * cfg.mcmc_steps),
            **stats, "tolerance": {"z_rel": CHAIN_Z_RTOL, "accept_margin": ACCEPT_MARGIN}}


def _step_stats():
    return {"steps": 0, "ties_within_margin": 0, "flips_within_margin": 0,
            "flips_outside_margin": 0, "max_z_rel_err": 0.0}


def _compare_step(stats, acc, alpha, u, z, other_acc, other_z):
    """Fold one MCMC step's comparison into ``stats``: ties (|u - alpha| <
    ACCEPT_MARGIN), flipped decisions inside and outside the margin, and
    z's largest error relative to max(1, |z|) over rows decided alike."""
    tie = (u - alpha).abs() < ACCEPT_MARGIN
    flip = acc != other_acc
    stats["ties_within_margin"] += int(tie.sum())
    stats["flips_within_margin"] += int((flip & tie).sum())
    stats["flips_outside_margin"] += int((flip & ~tie).sum())
    same = ~flip
    if bool(same.any()):
        err = ((z - other_z).abs() / z.abs().clamp_min(1.0))[same]
        stats["max_z_rel_err"] = max(stats["max_z_rel_err"], float(err.max()))
    stats["steps"] += 1


def compare_geodesic(torch, manager):
    """One geodesic batch at B=64 from the same draws on the card and on the
    CPU: prior latents, the flows' trajectory and the decoded frames."""
    from rlvae_tpu_torch.flows.temporal import apply_temporal_flows

    b = GEN_BATCHES[-1]
    gen = torch.Generator(device=manager.device).manual_seed(23)
    noise = manager.model.draw_generation_noise(b, "geodesic", gen)
    cpu_model = copy.deepcopy(manager.model).to("cpu")
    out = []
    for model, nz in ((manager.model, noise), (cpu_model, {k: v.cpu() for k, v in noise.items()})):
        with torch.no_grad():
            z0 = model.sample_riemannian_prior(b, "geodesic", noise=nz)
            z_seq, _ = apply_temporal_flows(model.flows, z0, 8)
            x = model.generate(b, 8, "geodesic", noise=nz)
        out.append((z0.float().cpu(), z_seq.float().cpu(), x.float().cpu()))
    (z0_g, zs_g, x_g), (z0_c, zs_c, x_c) = out
    z_scale = zs_c.abs().amax(dim=(0, 2)).clamp_min(1e-12)
    got = {"z0": float((z0_g - z0_c).abs().max()),
           "z_rel": float(((zs_g - zs_c).abs().amax(dim=(0, 2)) / z_scale).max()),
           "recon_mean_abs": float((x_g - x_c).abs().mean())}
    for k in got:
        check(got[k] <= E2E_TOL[k], f"geodesic generate card vs CPU: {k} = {got[k]} > {E2E_TOL[k]}")
    return {"batch": b, "errors": got, "tolerances": {k: E2E_TOL[k] for k in got},
            "recon_max_abs": float((x_g - x_c).abs().max())}


# ---------------------------------------------------------------------------
# posterior phase
# ---------------------------------------------------------------------------


def geodesic_hybrid_config():
    """``PRESETS["hybrid_rlvae"]`` with ``sampling.method: geodesic``."""
    from rlvae_tpu_torch.models import PRESETS

    cfg = copy.deepcopy(PRESETS["hybrid_rlvae"])
    cfg["sampling"]["method"] = "geodesic"
    return cfg


def run_posterior(torch, dev=None):
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig

    t0 = time.perf_counter()
    manager = ModelManager.from_config(geodesic_hybrid_config(), seed=0, device=dev)
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    check(manager.model.sampling_method == "geodesic" and manager.model.metric.n_centroids == 200,
          "the geodesic hybrid model was not built")
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)

    # one B=64 reconstruct bucket through the engine, warm
    engine = BatchingEngine.from_manager(
        manager, ServeConfig(buckets=(SERVE_BATCH,), max_wait_ms=2000))
    try:
        engine.warmup({"reconstruct": seqs[0]})
        torch.cuda.synchronize()
        zero_launch_counts()
        t = time.perf_counter()
        futs = [engine.submit("reconstruct", s_) for s_ in seqs]
        rows = [f.result(timeout=60) for f in futs]
        bucket_ms = (time.perf_counter() - t) * 1e3
        counts = launch_counts()
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
    check(stats["batches"] == 1, f"the {SERVE_BATCH} requests took {stats['batches']} dispatches")
    check(counts == expected_launches(metric_bundle=1, iaf_chain_fwd=1),
          f"one geodesic reconstruct batch launched {counts}")
    for r in rows:
        check(r.shape == (8, 3, 64, 64) and np.isfinite(r).all(), "bad reconstruct result")

    # one B=64 forward on the card vs the same model on the CPU, same noise
    gen = torch.Generator(device=manager.device).manual_seed(3)
    noise = manager.model.draw_posterior_noise(SERVE_BATCH, gen)
    check(sorted(noise) == ["eps", "t"], f"geodesic noise {sorted(noise)}")
    before = launch_counts()["metric_bundle"]
    out_gpu = manager.forward(seqs, noise=noise)
    torch.cuda.synchronize()
    forward_launches = launch_counts()["metric_bundle"] - before
    check(forward_launches == 1, f"the forward launched G {forward_launches} times, not once")
    cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu")
    out_cpu = cpu.forward(seqs, noise={k: v.cpu() for k, v in noise.items()})
    compare = compare_forward(torch, out_gpu, out_cpu)
    forward_b64 = profile_forward(torch, manager, seqs, noise)

    # training: the train phase's run and gates on the geodesic model
    train = run_train(torch, geodesic_hybrid_config(), steps=POSTERIOR_TRAIN_STEPS,
                      per_step=expected_launches(metric_bundle=1, iaf_chain_fwd=1,
                                                 iaf_chain_bwd=1), dev=dev)

    # the shipped hybrid_rlvae (enhanced posterior) reconstructs once
    shipped = ModelManager.from_config(PRESETS["hybrid_rlvae"], seed=0, device=dev)
    check(shipped.model.sampling_method == "enhanced", "the shipped preset is not 'enhanced'")
    before = launch_counts()
    x = shipped.reconstruct(seqs[:8])
    got = {k: v - before[k] for k, v in launch_counts().items()}
    check(x.shape == (8, 8, 3, 64, 64) and np.isfinite(x).all(), "bad enhanced reconstruct")
    check(got == expected_launches(chol_bundle=1, iaf_chain_fwd=1),
          f"one enhanced reconstruct launched {got}")

    totals = {k: counts[k] + train["launches"][k] + got[k] for k in counts}
    return {
        "model": "hybrid_rlvae, sampling.method=geodesic", "load_s": load_s,
        "reconstruct_bucket": {"batch": SERVE_BATCH, "host_ms": bucket_ms, "launches": counts,
                               "stats": {k: v for k, v in stats.items()
                                         if not k.endswith("_hist")}},
        "cuda_vs_cpu": compare, "forward_b64": forward_b64, "train": train,
        "enhanced_reconstruct_launches": got, "launches": totals,
        "metric_bundle_launches_per_forward": forward_launches,
    }


# ---------------------------------------------------------------------------
# fast phase
# ---------------------------------------------------------------------------


def run_fast(torch, dev=None):
    """The fast preset: Trainer steps with the fused decode+MSE loss, then one
    B=64 reconstruct bucket and a B=64 forward against the CPU."""
    from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig

    preset = PRESETS["riemannian_flow_vae_fast"]
    train = run_train(torch, preset, per_step=expected_launches(
        chol_bundle=2, decode_mse_fwd=1, decode_mse_bwd_dh=1, decode_mse_bwd_dw=1), dev=dev)

    t0 = time.perf_counter()
    manager = ModelManager.from_config(preset, seed=0, device=dev)
    check(dev is not None or manager.device.type == "cuda", f"manager on {manager.device}")
    check(manager.model.fused_decode_mse and manager.model.flows.direction == "sampling",
          "the fast preset was not built")
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(6)
    seqs = rng.uniform(size=(SERVE_BATCH, 8, 3, 64, 64)).astype(np.float32)
    engine = BatchingEngine.from_manager(
        manager, ServeConfig(buckets=(SERVE_BATCH,), max_wait_ms=2000))
    try:
        engine.warmup({"reconstruct": seqs[0]})
        torch.cuda.synchronize()
        zero_launch_counts()
        t = time.perf_counter()
        futs = [engine.submit("reconstruct", s_) for s_ in seqs]
        rows = [f.result(timeout=60) for f in futs]
        bucket_ms = (time.perf_counter() - t) * 1e3
        counts = launch_counts()
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
    check(stats["batches"] == 1, f"the {SERVE_BATCH} requests took {stats['batches']} dispatches")
    # serving never takes the fused loss (train=False): the posterior and the KL
    check(counts == expected_launches(chol_bundle=2),
          f"one fast reconstruct batch launched {counts}")
    for r in rows:
        check(r.shape == (8, 3, 64, 64) and np.isfinite(r).all(), "bad reconstruct result")

    eps = torch.tensor(rng.normal(size=(SERVE_BATCH, 16)), dtype=torch.float32)
    out_gpu = manager.forward(seqs, eps=eps.to(manager.device))
    torch.cuda.synchronize()
    cpu = ModelManager(copy.deepcopy(manager.model).to("cpu"), device="cpu")
    compare = compare_forward(torch, out_gpu, cpu.forward(seqs, eps=eps))
    return {
        "model": "riemannian_flow_vae_fast", "load_s": load_s, "train": train,
        "reconstruct_bucket": {"batch": SERVE_BATCH, "host_ms": bucket_ms, "launches": counts,
                               "stats": {k: v for k, v in stats.items()
                                         if not k.endswith("_hist")}},
        "cuda_vs_cpu": compare,
        "forward_b64": profile_forward(torch, manager, seqs, {"eps": eps.to(manager.device)}),
        "launches": {k: counts[k] + train["launches"][k] for k in counts},
    }


# ---------------------------------------------------------------------------
# ep phase
# ---------------------------------------------------------------------------


def _terms_err(got, want):
    """({log_pi_abs, grad_rel}, within the HMC tolerances) of two (log pi,
    grad) pairs; grad relative to the largest |entry| of ``want``."""
    lp = float((got[0] - want[0]).abs().max())
    g = float((got[1] - want[1]).abs().max()) / float(want[1].abs().max().clamp_min(1e-30))
    return {"log_pi_abs": lp, "grad_rel": g}, lp <= HMC_LP_ATOL and g <= HMC_RTOL


def ep_terms_checks(torch, dev, metric):
    """At the model's K=50 metric and the K=20 000 bank, B=64 rows near the
    centroids: ``hmc_terms_sharded`` on the 1 x 1 mesh against ``hmc_terms``
    (B4), and the bank split into EP_SHARDS padded shards in this process
    (``hmc_partials`` on each, summed in shard order as one flat buffer, then
    the epilogue) against the whole bank."""
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.ops.metric_kernels import hmc_partials, hmc_terms
    from rlvae_tpu_torch.parallel import create_mesh, hmc_terms_sharded, pad_metric, shard_metric
    from rlvae_tpu_torch.parallel.metric_parallel import _finish_hmc_terms
    from rlvae_tpu_torch.samplers.hmc import LOG_EPS

    mesh = create_mesh()
    label, c, m, temp, reg = metric_banks()[-1]
    banks = [("metric_T0.7_scaled.npz(K=50)", metric),
             (label, CentroidMetric(torch.tensor(c, device=dev), torch.tensor(m, device=dev),
                                    temp, reg))]
    rng = np.random.default_rng(12)
    out = []
    for label, bank in banks:
        b, d = SERVE_BATCH, bank.centroids.shape[1]
        zn = bank.centroids.cpu().numpy()[rng.integers(0, bank.n_centroids, size=b)]
        z = torch.tensor(zn + 0.05 * rng.normal(size=zn.shape), dtype=torch.float32, device=dev)
        inv_t2 = 1.0 / bank.temperature ** 2
        whole = hmc_terms_sharded(mesh, shard_metric(mesh, bank), z)
        dense = hmc_terms(z, bank.centroids, bank.matrices, inv_t2, bank.regularization, LOG_EPS)
        padded = pad_metric(bank, EP_SHARDS)
        per, buf = padded.n_centroids // EP_SHARDS, None
        for i in range(EP_SHARDS):
            rows = slice(i * per, (i + 1) * per)
            gi, v = hmc_partials(z, padded.centroids[rows].contiguous(),
                                 padded.matrices[rows].contiguous(), inv_t2)
            part = torch.cat([gi.reshape(b, d * d), v], dim=1)
            buf = part if buf is None else buf + part
        split = _finish_hmc_terms(buf[:, : d * d].reshape(b, d, d), buf[:, d * d:],
                                  bank.regularization)
        torch.cuda.synchronize()
        vs_dense, ok_dense = _terms_err(whole, dense)
        vs_whole, ok_split = _terms_err(split, whole)
        check(ok_dense, f"hmc_terms_sharded vs hmc_terms at {label}: {vs_dense}")
        check(ok_split, f"{EP_SHARDS} shards vs the whole bank at {label}: {vs_whole}")
        out.append({"bank": label, "batch": b, "padded_k": padded.n_centroids,
                    "ep_vs_hmc_terms": vs_dense, "shards_vs_whole_bank": vs_whole})
    return out


def replay_ep_chain(torch, metric, cpu_metric, noise, cfg, z_chain):
    """The EP chain one MCMC step at a time on the card (the sharded terms
    on the 1 x 1 mesh), each step replayed on the CPU (the plain partials,
    the same epilogue) from the card's state before it with the same
    momenta and uniforms; the first EP_DENSE_STEPS also taken on the card
    with the dense ``hmc_terms`` (B4) from the same state."""
    from rlvae_tpu_torch.parallel import create_mesh, hmc_terms_sharded, shard_metric
    from rlvae_tpu_torch.samplers import mcmc_step
    from rlvae_tpu_torch.samplers.hmc import _terms_fn

    mesh = create_mesh()
    bank, cpu_bank = shard_metric(mesh, metric), shard_metric(mesh, cpu_metric)
    terms = {"card": lambda zz: hmc_terms_sharded(mesh, bank, zz),
             "cpu": lambda zz: hmc_terms_sharded(mesh, cpu_bank, zz),
             "dense": _terms_fn(metric)}
    stats = {k: _step_stats() for k in ("cpu", "dense")}
    accepted = 0
    with torch.no_grad():
        log_pi, grad = terms["card"](noise["z0"])
        state = (noise["z0"], log_pi, -grad, np.float32(1.0))
        for step in range(cfg.mcmc_steps):
            gamma, u = noise["gammas"][step], noise["unifs"][step]
            nxt, acc, alpha = mcmc_step(terms["card"], state, gamma, u, cfg)
            others = [("cpu", tuple(t.cpu() for t in state[:3]) + (state[3],), gamma.cpu(),
                       u.cpu())]
            if step < EP_DENSE_STEPS:
                others.append(("dense", state, gamma, u))
            for name, st, g, uu in others:
                o_nxt, o_acc, _ = mcmc_step(terms[name], st, g, uu, cfg)
                _compare_step(stats[name], acc.cpu(), alpha.cpu(), u.cpu(), nxt[0].cpu(),
                              o_acc.cpu(), o_nxt[0].cpu())
            accepted += int(acc.sum())
            state = nxt
    check(torch.equal(state[0], z_chain), "the stepped EP chain differs from the entry point's")
    for name, st in stats.items():
        check(st["flips_outside_margin"] == 0,
              f"EP chain vs {name}: {st['flips_outside_margin']} accept flips outside the margin")
        check(st["max_z_rel_err"] <= CHAIN_Z_RTOL,
              f"EP chain vs {name}: z differs by {st['max_z_rel_err']} of scale")
    check(accepted > 0, "the EP chain accepted nothing")
    return {"batch": int(z_chain.shape[0]), "steps": cfg.mcmc_steps, "accepted": accepted,
            "accept_rate": accepted / (z_chain.shape[0] * cfg.mcmc_steps),
            "vs_cpu_replay": stats["cpu"], "vs_dense_hmc_terms": stats["dense"],
            "tolerance": {"z_rel": CHAIN_Z_RTOL, "accept_margin": ACCEPT_MARGIN}}


def run_ep(torch, dev=None):
    """The centroid-sharded HMC path on one card: terms checks, the official
    chain through ``sample_prior_hmc_sharded`` with the launch counters
    zeroed just before and read just after, the busy share of a profiled
    short chain, the dense B4 chain on the same draws for scale, and the
    step-by-step replay."""
    from rlvae_tpu_torch.geometry import load_metric
    from rlvae_tpu_torch.geometry.metric import CentroidMetric, chol_g_inv
    from rlvae_tpu_torch.parallel import (
        all_reduce_sum,
        chol_g_inv_sharded,
        create_mesh,
        sample_prior_hmc_sharded,
        shard_metric,
    )
    from rlvae_tpu_torch.samplers import HMCConfig, draw_hmc_noise, sample_prior_hmc

    dev = dev or torch.device("cuda")
    cpu_metric = load_metric(PRETRAINED / "metric_T0.7_scaled.npz", temperature_override=3.0)
    metric = CentroidMetric(cpu_metric.centroids.to(dev), cpu_metric.matrices.to(dev),
                            cpu_metric.temperature, cpu_metric.regularization)
    terms_checks = ep_terms_checks(torch, dev, metric)

    mesh = create_mesh()
    check(mesh.shape == {"data": 1, "model": 1} and mesh.model_group is None,
          f"one process should lay out a 1 x 1 mesh, got {mesh}")
    cfg, b = HMCConfig(), SERVE_BATCH
    noise = draw_hmc_noise(metric, b, cfg, torch.Generator(device=dev).manual_seed(17))

    def short(steps):
        return {"z0": noise["z0"], "gammas": noise["gammas"][:steps],
                "unifs": noise["unifs"][:steps]}

    sample_prior_hmc_sharded(mesh, metric, b, HMCConfig(mcmc_steps=1), **short(1))  # warm-up
    torch.cuda.synchronize()
    calls_before = dict(all_reduce_sum.calls)
    zero_launch_counts()
    t = time.perf_counter()
    z, diag = sample_prior_hmc_sharded(mesh, metric, b, cfg, **noise, return_diagnostics=True)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t
    launches = launch_counts()
    calls = {a: n - calls_before[a] for a, n in all_reduce_sum.calls.items()}
    check(launches == expected_launches(hmc_partials=CHAIN_LAUNCHES),
          f"the EP chain launched {launches}")
    check(calls == {"data": cfg.mcmc_steps, "model": CHAIN_LAUNCHES},
          f"the EP chain made {calls} all-reduce calls")
    check(z.shape == (b, 16) and bool(torch.isfinite(z).all())
          and bool(torch.isfinite(diag["log_pi"]).all()), "bad EP chain output")

    # the sharded Cholesky factor: the shard's G^{-1} from the G^{-1} kernel (B7),
    # then the all-reduce, + lbd I and the factorization, against the dense
    # chol-bundle (B1) on the same rows
    g_inv_before = _wrappers()["g_inv"].launches
    l_sharded = chol_g_inv_sharded(mesh, shard_metric(mesh, metric), noise["z0"])
    torch.cuda.synchronize()
    g_inv_launched = _wrappers()["g_inv"].launches - g_inv_before
    l_dense = chol_g_inv(metric, noise["z0"])
    chol_err = (l_sharded - l_dense).abs()
    check(g_inv_launched == 1, f"chol_g_inv_sharded launched g_inv {g_inv_launched} times")
    check(bool((chol_err <= CHOL_ATOL + CHOL_RTOL * l_dense.abs()).all()),
          f"chol_g_inv_sharded disagrees with chol_g_inv: {float(chol_err.max())}")

    # the busy share of a short chain: host clock unprofiled, device time profiled
    short_cfg = HMCConfig(mcmc_steps=EP_PROFILE_STEPS)
    run_short = lambda: sample_prior_hmc_sharded(mesh, metric, b, short_cfg,  # noqa: E731
                                                 **short(EP_PROFILE_STEPS))
    torch.cuda.synchronize()
    t = time.perf_counter()
    run_short()
    torch.cuda.synchronize()
    short_ms = (time.perf_counter() - t) * 1e3
    busy_ms, kernels = device_time_by_kernel(torch, run_short)
    evals = 1 + EP_PROFILE_STEPS * (cfg.n_lf + 1)

    # the dense chain (B4) on the same draws, for scale
    torch.cuda.synchronize()
    t = time.perf_counter()
    z_dense = sample_prior_hmc(metric, b, cfg, **noise)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t

    return {
        "bank": "metric_T0.7_scaled.npz(K=50) at T=3.0", "mesh": mesh.shape, "batch": b,
        "terms_checks": terms_checks,
        "chain": {"mcmc_steps": cfg.mcmc_steps, "n_lf": cfg.n_lf, "host_s": chain_s,
                  "launches": launches, "all_reduce_calls": calls,
                  "accept_rate": float(diag["accept_rate"])},
        "short_chain": {"mcmc_steps": EP_PROFILE_STEPS, "host_ms": short_ms,
                        "profiled_device_busy_ms": busy_ms, "device_busy_share": busy_ms / short_ms,
                        "n_kernel_launches": sum(k["calls"] for k in kernels),
                        "kernel_launches_per_evaluation": sum(k["calls"] for k in kernels) / evals,
                        "top_kernels": kernels[:8]},
        "dense_chain": {"host_s": dense_s, "ep_over_dense": chain_s / dense_s,
                        "max_abs_z_diff_vs_ep": float((z_dense - z).abs().max())},
        "chol_g_inv_sharded": {"batch": b, "g_inv_launches": g_inv_launched,
                               "max_abs_err_vs_dense_chol_bundle": float(chol_err.max()),
                               "tolerance": f"{CHOL_ATOL} + {CHOL_RTOL}|dense|"},
        "replay": replay_ep_chain(torch, metric, cpu_metric, noise, cfg, z),
        "launches": launches,
    }


# ---------------------------------------------------------------------------
# dense_chain phase
# ---------------------------------------------------------------------------


def run_dense_chain(torch, dev=None):
    """The official chain (100 x 15) at B=64 through ``sample_prior_hmc`` on
    the K=20 000 bank of :func:`metric_banks`, where the HMC terms kernel
    (B4) sets the wall time: host seconds with the launch counters zeroed just
    before and read just after (1601 ``hmc_terms``), the profiled device time
    and busy share of a second run, and the first DENSE_REPLAY_STEPS MCMC
    steps replayed on the CPU (plain terms) from the card's state."""
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.ops.metric_kernels import launch_hmc_geometry
    from rlvae_tpu_torch.samplers import HMCConfig, draw_hmc_noise, mcmc_step, sample_prior_hmc
    from rlvae_tpu_torch.samplers.hmc import _terms_fn

    dev = dev or torch.device("cuda")
    label, c, m, temp, reg = metric_banks()[-1]
    metric = CentroidMetric(torch.tensor(c, device=dev), torch.tensor(m, device=dev), temp, reg)
    cpu_metric = CentroidMetric(torch.tensor(c), torch.tensor(m), temp, reg)
    cfg, b = HMCConfig(), SERVE_BATCH
    noise = draw_hmc_noise(metric, b, cfg, torch.Generator(device=dev).manual_seed(29))
    sample_prior_hmc(metric, b, HMCConfig(mcmc_steps=1), z0=noise["z0"],
                     gammas=noise["gammas"][:1], unifs=noise["unifs"][:1])  # warm-up
    torch.cuda.synchronize()
    zero_launch_counts()
    t = time.perf_counter()
    z = sample_prior_hmc(metric, b, cfg, **noise)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    launches = launch_counts()
    check(launches == expected_launches(hmc_terms=CHAIN_LAUNCHES),
          f"the dense K=20 000 chain launched {launches}")
    check(z.shape == (b, 16) and bool(torch.isfinite(z).all()), "bad dense chain output")
    busy_ms, kernels = device_time_by_kernel(torch, lambda: sample_prior_hmc(metric, b, cfg,
                                                                              **noise))
    terms_us = sum(k["us"] for k in kernels if "hmc_terms" in k["name"])

    # the first steps, each replayed on the CPU from the card's state before it;
    # and the same steps with every proposal accepted (u = -1), so that the
    # leapfrog endpoints are compared even where the chain rejects
    terms, cpu_terms = _terms_fn(metric), _terms_fn(cpu_metric)
    stats, proposals, accepted = _step_stats(), _step_stats(), 0
    with torch.no_grad():
        log_pi, grad = terms(noise["z0"])
        state = (noise["z0"], log_pi, -grad, np.float32(1.0))
        for step in range(DENSE_REPLAY_STEPS):
            gamma, u = noise["gammas"][step], noise["unifs"][step]
            cpu_state = tuple(t.cpu() for t in state[:3]) + (state[3],)
            for st, uu in ((proposals, torch.full_like(u, -1.0)), (stats, u)):
                nxt, acc, alpha = mcmc_step(terms, state, gamma, uu, cfg)
                c_nxt, c_acc, _ = mcmc_step(cpu_terms, cpu_state, gamma.cpu(), uu.cpu(), cfg)
                _compare_step(st, acc.cpu(), alpha.cpu(), uu.cpu(), nxt[0].cpu(), c_acc,
                              c_nxt[0])
            accepted += int(acc.sum())
            state = nxt
    check(stats["flips_outside_margin"] == 0,
          f"dense chain: card and CPU accept decisions differ on "
          f"{stats['flips_outside_margin']} non-tie rows")
    check(stats["max_z_rel_err"] <= CHAIN_Z_RTOL,
          f"dense chain vs CPU replay: z differs by {stats['max_z_rel_err']} of scale")
    return {
        "rows_moved": int((z != noise["z0"]).any(1).sum()),
        "bank": f"{label} at T={temp}", "batch": b, "mcmc_steps": cfg.mcmc_steps,
        "n_lf": cfg.n_lf, "geometry": list(launch_hmc_geometry(b, c.shape[0], dev)),
        "host_s": host_s, "profiled_device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (host_s * 1e3),
        "hmc_terms_profiled_ms": terms_us / 1e3,
        "n_kernel_launches": sum(k["calls"] for k in kernels), "top_kernels": kernels[:6],
        "launches": launches,
        "replay": {"steps": DENSE_REPLAY_STEPS, "accepted": accepted, **stats,
                   "every_proposal_accepted": proposals,
                   "tolerance": {"z_rel": CHAIN_Z_RTOL, "accept_margin": ACCEPT_MARGIN}},
    }


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
         ptxas=[ln.strip() for ln in lib.log.splitlines()
                if "Compiling entry" in ln or "registers" in ln or "spill" in ln])
    print(f"build_seconds {lib.seconds:.3f}", flush=True)

    records = {}
    for name, run in (("chol_bundle", run_chol_checks), ("iaf_chain_fwd", run_iaf_checks),
                      ("iaf_chain_bwd", run_iaf_bwd_checks), ("hmc_terms", run_hmc_checks),
                      ("hmc_partials", run_partials_checks)):
        records[name], cases = run(torch, dev)
        emit("kernels", kernel=name, tolerance=records[name]["tolerance"], cases=cases)
    for name, (record, cases) in run_bundle_checks(torch, dev).items():
        records[name] = record
        emit("kernels", kernel=name, tolerance=record["tolerance"], cases=cases)
    for name, (record, cases) in run_decode_checks(torch, dev).items():
        records[name] = record
        emit("kernels", kernel=name, tolerance=record["tolerance"], cases=cases)

    serve = run_serve(torch)
    emit("serve", **serve)
    train = run_train(torch)
    emit("train", **train)
    generate = run_generate(torch)
    emit("generate", **generate)
    posterior = run_posterior(torch)
    emit("posterior", **posterior)
    fast = run_fast(torch)
    emit("fast", **fast)
    ep = run_ep(torch)
    emit("ep", **ep)
    dense = run_dense_chain(torch)
    emit("dense_chain", **dense)
    # launches: the sum over the seven main paths' runs (each read between
    # zeroing the counters and the end of its run), with each path's count
    # beside it; every kernel is launched by the paths it belongs to
    paths = {"serve": (serve["launches"], ("chol_bundle", "iaf_chain_fwd")),
             "train": (train["launches"], ("chol_bundle", "iaf_chain_fwd", "iaf_chain_bwd",
                                           "g_inv")),
             "generate": (generate["launches"], ("chol_bundle", "iaf_chain_fwd", "hmc_terms",
                                                 "g_inv")),
             "posterior": (posterior["launches"], ("chol_bundle", "iaf_chain_fwd", "iaf_chain_bwd",
                                                   "metric_bundle", "g_inv")),
             "fast": (fast["launches"], ("chol_bundle", "g_inv", "decode_mse_fwd",
                                         "decode_mse_bwd_dh", "decode_mse_bwd_dw")),
             "ep": (ep["launches"], ("hmc_partials",)),
             "dense_chain": (dense["launches"], ("hmc_terms",))}
    for path, (counts, kernels) in paths.items():
        for name in kernels:
            check(counts[name] > 0, f"the {path} path did not launch {name}")
    for name, rec in records.items():
        rec["launches"] = sum(counts[name] for counts, _ in paths.values())
        for path, (counts, _) in paths.items():
            rec[f"launches_{path}"] = counts[name]
        rec["launches_per_train_step"] = train["launches_per_step"][name]
        rec["launches_per_geodesic_train_step"] = posterior["train"]["launches_per_step"][name]
        rec["launches_per_fast_train_step"] = fast["train"]["launches_per_step"][name]
    records["hmc_terms"]["launches_per_official_chain"] = next(
        c["launches"]["hmc_terms"] for c in generate["calls"] if c["method"] == "official")
    records["metric_bundle"]["launches_per_geodesic_forward"] = (
        posterior["metric_bundle_launches_per_forward"])
    records["hmc_partials"]["launches_per_ep_chain"] = ep["launches"]["hmc_partials"]
    records["hmc_terms"]["launches_per_dense_k20000_chain"] = dense["launches"]["hmc_terms"]

    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
