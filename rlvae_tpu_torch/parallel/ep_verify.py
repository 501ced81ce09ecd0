"""Run the centroid-sharded (EP) metric path across processes and check it.

    python -m rlvae_tpu_torch.parallel.ep_verify --world 4 --model-parallel 2 \\
        --device cpu --out /tmp/ep

The counterpart of the EP segment of ``scripts/multihost_verify.py``
(``_run_ep_segment``).  The launcher starts ``--world`` ranks as
subprocesses of this module (:mod:`.launch`).  They join one process group
through a ``file://`` store under ``--out`` (gloo for ``--device cpu``; NCCL
with one card per rank for ``--device cuda``, the default) and lay themselves out as
a (world / model-parallel) x model-parallel mesh.  Each rank reads the bank,
the rows z and the chains' draws from ``OUT/inputs.npz`` (written from
``--seed`` when absent), runs ``hmc_terms_sharded``, ``g_inv_sharded``,
``chol_g_inv_sharded`` and a short ``sample_prior_hmc_sharded`` per chain,
and writes its rows and its all-reduce counts to ``OUT/rank{r}.npz``.

The launcher then assembles the global arrays into ``OUT/result.npz``,
holds them against the dense single-process plain path on the CPU (log pi
atol 1e-5, grad and G^{-1} 1e-4 and 1e-5, L 1e-4, chain z 1e-4 and accept
rate 1e-6), checks that the ranks of one model group agree bit for bit and
that each evaluation of the terms made exactly one model-group all-reduce,
prints one JSON line and exits non-zero on any failure.  Every wait is
bounded: the process group's own timeout and ``--timeout`` for the whole
run.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import sys
from pathlib import Path

import numpy as np

TOL = {"log_pi": 1e-5, "grad": 1e-4, "g_inv": 1e-5, "chol": 1e-4, "chain_z": 1e-4,
       "accept_rate": 1e-6}


def make_inputs(path: Path, seed: int, rows: int) -> None:
    """A K=37 bank (not divisible by any shard count) at T=2.0, ``rows``
    rows of z near its centroids, and one short chain per init, from
    ``seed``.  At that temperature several centroids weigh on every point
    near the bank, so each shard's partial sum matters; both chains start
    there (the ``randn`` one at centroids plus 0.3 x normal noise), where
    the metric's gradient is not 0."""
    rng = np.random.default_rng(seed)
    k, d = 37, 16
    a = rng.normal(size=(k, d, d)).astype(np.float32) * 0.2
    c = rng.normal(size=(k, d)).astype(np.float32)
    z = c[rng.integers(0, k, rows)] + 0.2 * rng.normal(size=(rows, d)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(d, dtype=np.float32)
    arrays = {"centroids": c, "matrices": m,
              "temperature": np.float32(2.0), "regularization": np.float32(0.01),
              "z": z.astype(np.float32), "chains": np.array(["centroids", "randn"])}
    steps = 4
    for init in ("centroids", "randn"):
        z0 = c[rng.integers(0, k, rows)]
        if init == "randn":
            z0 = z0 + 0.3 * rng.normal(size=(rows, d))
        arrays[f"{init}_z0"] = z0.astype(np.float32)
        arrays[f"{init}_gammas"] = rng.normal(size=(steps, rows, d)).astype(np.float32)
        arrays[f"{init}_unifs"] = rng.uniform(size=(steps, rows)).astype(np.float32)
        arrays[f"{init}_config"] = np.array([steps, 3, 0.05, 1.0])
    np.savez(path, **arrays)


def _config(init: str, values):
    from rlvae_tpu_torch.samplers.hmc import HMCConfig

    steps, n_lf, eps_lf, beta_zero = (float(x) for x in values)
    return HMCConfig(mcmc_steps=int(steps), n_lf=int(n_lf), eps_lf=eps_lf,
                     beta_zero=beta_zero, init=init)


def _metric(inputs, device):
    import torch

    from rlvae_tpu_torch.geometry.metric import CentroidMetric

    m = CentroidMetric.create(inputs["centroids"], inputs["matrices"],
                              float(inputs["temperature"]), float(inputs["regularization"]))
    return CentroidMetric(m.centroids.to(device), m.matrices.to(device), m.temperature,
                          m.regularization)


def run_rank(args) -> None:
    """One rank: join the group, run every sharded function, write rank{r}.npz."""
    import torch
    import torch.distributed as dist

    from rlvae_tpu_torch.parallel import metric_parallel as mp
    from rlvae_tpu_torch.parallel.launch import default_backend, init_world
    from rlvae_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, create_mesh

    # a rank that hangs writes every thread's stack to its log and exits
    # before the launcher's deadline
    faulthandler.dump_traceback_later(max(1.0, args.timeout - 10.0), exit=True)
    out = Path(args.out).resolve()
    device = init_world(default_backend(args.device), args.world, args.rank, out, args.device)
    try:
        mesh = create_mesh(args.model_parallel)
        inputs = np.load(out / "inputs.npz")
        metric = _metric(inputs, device)
        bank = mp.shard_metric(mesh, metric)
        z = mp.local_rows(mesh, torch.tensor(inputs["z"], device=device))
        calls = mp.all_reduce_sum.calls
        before = dict(calls)
        log_pi, grad = mp.hmc_terms_sharded(mesh, bank, z)
        res = {"data_index": mesh.data_index, "model_index": mesh.model_index,
               "log_pi": log_pi, "grad": grad,
               "terms_model_calls": calls[MODEL_AXIS] - before[MODEL_AXIS],
               "terms_data_calls": calls[DATA_AXIS] - before[DATA_AXIS],
               "g_inv": mp.g_inv_sharded(mesh, bank, z),
               "chol": mp.chol_g_inv_sharded(mesh, bank, z)}
        for init in inputs["chains"]:
            init = str(init)
            before = dict(calls)
            zc, diag = mp.sample_prior_hmc_sharded(
                mesh, metric, inputs[f"{init}_z0"].shape[0],
                _config(init, inputs[f"{init}_config"]),
                z0=torch.tensor(inputs[f"{init}_z0"]),
                gammas=torch.tensor(inputs[f"{init}_gammas"]),
                unifs=torch.tensor(inputs[f"{init}_unifs"]), return_diagnostics=True)
            res.update({f"{init}_z": zc, f"{init}_accept_rate": diag["accept_rate"],
                        f"{init}_log_pi": diag["log_pi"],
                        f"{init}_model_calls": calls[MODEL_AXIS] - before[MODEL_AXIS],
                        f"{init}_data_calls": calls[DATA_AXIS] - before[DATA_AXIS]})
        np.savez(out / f"rank{args.rank}.npz",
                 **{k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                    for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def launch(args) -> int:
    """Start every rank, wait with a deadline, then assemble and check."""
    from rlvae_tpu_torch.parallel.launch import check_backend, default_backend, rank_logs, \
        spawn_ranks

    out = Path(args.out).resolve()  # the file:// store needs an absolute path
    out.mkdir(parents=True, exist_ok=True)
    dp = args.world // args.model_parallel
    if args.world < 1 or args.model_parallel < 1 or dp * args.model_parallel != args.world:
        raise SystemExit(f"--world {args.world} must be a multiple of --model-parallel "
                         f"{args.model_parallel}")
    check_backend(default_backend(args.device), args.world, args.device)
    if not (out / "inputs.npz").exists():
        make_inputs(out / "inputs.npz", args.seed, rows=4 * dp)
    for stale in [out / "result.npz", *out.glob("rank*")]:
        stale.unlink(missing_ok=True)
    argv = ["--world", str(args.world), "--model-parallel", str(args.model_parallel),
            "--device", args.device, "--out", str(out), "--timeout", str(args.timeout)]
    failed = spawn_ranks("rlvae_tpu_torch.parallel.ep_verify", argv, args.world, out,
                         args.timeout)
    if failed:
        print(rank_logs(out, args.world), file=sys.stderr)
        print(json.dumps({"ok": False, "failed": failed}))
        return 1
    summary = check(out, args.world, args.model_parallel)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


def assemble(out: Path, world: int, model_parallel: int):
    """(global arrays by data index from model index 0, whether every model
    group's ranks agree bit for bit, each rank's outputs)."""
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
    dp = world // model_parallel
    agree = all(np.array_equal(ranks[d * model_parallel][k], ranks[d * model_parallel + m][k])
                for d in range(dp) for m in range(model_parallel) for k in ranks[0]
                if k != "model_index")
    rows = [ranks[d * model_parallel] for d in range(dp)]
    result = {}
    for k, v in ranks[0].items():
        result[k] = np.concatenate([r[k] for r in rows]) if v.ndim else v
    return result, agree, ranks


def check(out: Path, world: int, model_parallel: int) -> dict:
    """Assemble ``result.npz`` and hold it against the dense plain path."""
    import torch

    from rlvae_tpu_torch.ops import linalg as lin
    from rlvae_tpu_torch.ops.metric_kernels import g_inv_ref, hmc_terms_ref
    from rlvae_tpu_torch.samplers.hmc import LOG_EPS, run_prior_chain

    result, agree, ranks = assemble(out, world, model_parallel)
    np.savez(out / "result.npz", **result)
    inputs = np.load(out / "inputs.npz")
    metric = _metric(inputs, "cpu")
    inv_t2, lbd = 1.0 / metric.temperature ** 2, metric.regularization
    bank = (metric.centroids, metric.matrices, inv_t2)

    def terms(z):
        return hmc_terms_ref(z, *bank, lbd, LOG_EPS)

    z = torch.tensor(inputs["z"])
    want_lp, want_grad = terms(z)
    want_gi = g_inv_ref(z, *bank, lbd)
    errors = {"log_pi": float(np.abs(result["log_pi"] - want_lp.numpy()).max()),
              "grad": float(np.abs(result["grad"] - want_grad.numpy()).max()),
              "g_inv": float(np.abs(result["g_inv"] - want_gi.numpy()).max()),
              "chol": float(np.abs(result["chol"]
                                   - lin.cholesky_small(want_gi, jitter=1e-6).numpy()).max())}
    calls_ok = all(r["terms_model_calls"] == 1 and r["terms_data_calls"] == 0 for r in ranks)
    for init in inputs["chains"]:
        init = str(init)
        cfg = _config(init, inputs[f"{init}_config"])
        wz, rate, _ = run_prior_chain(terms, torch.tensor(inputs[f"{init}_z0"]),
                                      torch.tensor(inputs[f"{init}_gammas"]),
                                      torch.tensor(inputs[f"{init}_unifs"]), cfg)
        errors[f"{init}_chain_z"] = float(np.abs(result[f"{init}_z"] - wz.numpy()).max())
        errors[f"{init}_accept_rate"] = abs(float(result[f"{init}_accept_rate"]) - float(rate))
        evals = 1 + cfg.mcmc_steps * (cfg.n_lf + 1)
        calls_ok = calls_ok and all(r[f"{init}_model_calls"] == evals
                                    and r[f"{init}_data_calls"] == cfg.mcmc_steps for r in ranks)
    within = all(err <= TOL[k if k in TOL else k.split("_", 1)[1]] for k, err in errors.items())
    return {"ok": bool(within and agree and calls_ok), "world": world,
            "mesh": {"data": world // model_parallel, "model": model_parallel},
            "errors_vs_dense": errors, "tolerances": TOL, "model_ranks_agree": bool(agree),
            "one_model_all_reduce_per_evaluation": bool(calls_ok)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--model-parallel", type=int, default=1)
    parser.add_argument("--out", required=True, help="directory for inputs, store and results")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--seed", type=int, default=0, help="seed of inputs.npz when absent")
    parser.add_argument("--timeout", type=float, default=300.0,
                        help="seconds for the whole run, every rank included")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        run_rank(args)
        return 0
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
