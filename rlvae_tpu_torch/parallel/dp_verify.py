"""Run the data-parallel (and DP x TP) training path across processes and check it.

    python -m rlvae_tpu_torch.parallel.dp_verify --world 2 --device cpu --out /tmp/dp
    python -m rlvae_tpu_torch.parallel.dp_verify --world 4 --model-parallel 1,2 --device cpu \\
        --out /tmp/dptp
    python -m rlvae_tpu_torch.parallel.dp_verify --world 2 --device cuda --backend gloo \\
        --model riemannian_flow_vae --model-parallel 1,2 \\
        --extra cnn_rlvae@1,riemannian_flow_vae_fast@2 --out /tmp/dp_card

The counterpart of ``scripts/multihost_verify.py``.  The launcher starts
``--world`` ranks (:mod:`.launch`: a ``file://`` store under ``--out``,
bounded waits; gloo on the CPU, NCCL on the card unless ``--backend gloo``;
rank r on ``cuda:(r % device_count)``).  Each layout of
``--model-parallel`` (a comma list) runs in turn in the same world as a
(world / M) x M mesh.  The inputs come from ``OUT/inputs.npz`` (written
from ``--seed`` when absent; ``OUT/init.pt``, when present, holds the
initial weights, and ``model_config`` in the inputs a ``create_model``
config): a global batch ``x`` with one global noise draw per step, and
the training and validation sequences of the epoch phase.  Per layout,
each rank

1. builds a :class:`~rlvae_tpu_torch.train.Trainer` in the world
   (``devices`` the data axis, ``model_parallel`` the model axis) and runs
   ``--steps`` steps of its train step on its rows of ``x`` with the global
   noise, recording the metrics, the collectives of the first step
   (:mod:`.comm_audit`), the kernel launches per step, the BatchNorm
   statistics of step 1 before and after the data group's mean, the host
   time of each step (the ranks meet at a barrier first) and of the step's
   all-reduce alone, and on the card one profiled step's device time;
2. with ``--epochs`` > 0, trains a fresh Trainer that many epochs on its
   strided rows (``CyclicDataModule`` in the world), recording each step's
   local batch, noise and learning rate; resumes a third Trainer from the
   run's ``last`` slot; and checks that the chunked epoch gathers the
   resident one's batches;

with rank 0 saving the unsharded weights and Adam state before every step
(``mp{M}_{steps,epochs}_state{i}.pt``), and writes
``OUT/rank{r}_mp{M}.npz``.  ``--extra NAME@M,...`` adds the steps of
another model in the (world / M) x M layout (``rank{r}_NAME.npz``): the
``create_model`` config ``OUT/NAME.json`` or the model :func:`build_model`
names, with the weights of ``OUT/NAME.pt`` or its seeded init, on the
batch and noise of ``OUT/NAME_inputs.npz`` (written from ``--seed`` when
absent).  The launcher then holds every layout against one process of
plain PyTorch on the device of the run: the ranks' weights and metrics
equal bit for bit; each step replayed from the world's state on the whole
batch (BatchNorm-free models): the loss, step 1's grad_norm, Adam's first
moment leaf by leaf (the step's gradient, each leaf on its own) and the
weights' update leaf by leaf, at ``TOL`` on the CPU and ``CARD_TOL`` on
the card (set from readings of sound runs against planted faults); the
BatchNorm statistics against the mean of the shards' own; each rank's
epoch rows against the strided, staging-permuted rows and its
``host_epoch_perm`` column, row for row; each epoch step replayed as the
steps are; the last validation against one process's; the resume bit for
bit; and the first step's collectives against the plan (DP: one flat
all-reduce of [1.0, 1.25] x the parameter bytes, no all-gather; DP x TP
of the inputs' model: fewer bytes in all than the parameters, all-gathers
below half of them; of an ``--extra`` model: the plan's all-reduces and
some all-gathers).  It writes ``OUT/summary.json``, prints
it as one JSON line and exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import copy
import faulthandler
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

# The world's step against the plain step replayed from the same state, in
# one process on the CPU (:func:`replay`).  Set from readings of sound runs
# against planted faults (worlds of 2 and 4 CPU ranks, the 2 x 1, 1 x 2,
# 4 x 1 and 2 x 2 layouts of the small model, 3 steps and an epoch; a
# step's all-reduce replaced by one shard's gradients or dropped, two
# same-shape leaves swapped in the flat buffer's unflatten, the
# column-parallel bias gradient gathered in reverse order):
# - loss: sound <= 4.7e-7 (it reads the forward only);
# - step 1's grad_norm: sound <= 9.0e-6 (the default preset at full width
#   on 1 x 2: 2.0e-4), faults >= 3.5e-3 but for the swapped leaves, which
#   keep the norm;
# - Adam's first moment, worst leaf held: sound <= 7.7e-3 (the nets' bf16
#   products summed over another batch split), every fault >= 1.34;
# - the weights' update over the whole model, held: sound <= 0.025
#   (near-zero gradients flip an Adam update's sign, +-lr), the dropped or
#   one-shard all-reduce and the reversed gather >= 0.84 (another lr or a
#   doubled step reads 1.0; the swapped leaves 0.09, held by the moment).
TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-3, "exp_avg_rel": 5e-2, "update_rel": 0.2,
       "bn_rel": 1e-5}
# On the card the replay runs there too, with the same kernels.  Sound
# readings on an H100 (the default preset at full width in worlds of 1 and
# 2 ranks, its 2 x 1 and 1 x 2 layouts with an epoch, the fast preset on
# 1 x 2, and the small model): loss <= 5.7e-6, step 1's grad_norm <=
# 3.9e-3, the held first moment <= 2.9e-2 and update <= 2.4e-2, each the
# 1 x 2 layout's, where cuBLAS rounds the plain bf16 product of a
# row-parallel layer in another order than the layer's fp32 partial sums;
# one shard's gradients in place of the mean read >= 0.26 in grad_norm
# and >= 1.0 in the first moment.  The BatchNorm model the card runs has
# dropout, so ``bn_rel`` (the plain shard forward) is not read there.
CARD_TOL = {"loss_rtol": 5e-5, "grad_norm_rtol": 1e-2, "exp_avg_rel": 0.1, "update_rel": 0.2,
            "bn_rel": 1e-5}
# the small model of JAX's DP x TP parity test and comm audit
SMALL = {"input_dim": (3, 8, 8), "latent_dim": 16, "n_flows": 2, "flow_hidden_size": 32,
         "posterior_type": "gaussian", "use_riemannian": False}
LOSS_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty", "grad_norm")
CONF = Path(__file__).resolve().parents[2] / "conf"


def build_model(name: str, seed: int = 0, config: str = ""):
    """``small`` (JAX's test model), a preset of ``models.PRESETS``, a
    ``conf/model`` config composed at its published widths, or, when
    ``config`` is given, the ``create_model`` config it holds (JSON)."""
    from rlvae_tpu_torch.models import PRESETS, RlVAE, create_model

    if config:
        return create_model(json.loads(config), seed=seed)
    if name == "small":
        return RlVAE(**SMALL, seed=seed)
    if name in PRESETS:
        return create_model(PRESETS[name], seed=seed)
    from rlvae_tpu_torch.config import compose

    return create_model(compose(CONF, "config", [f"model={name}"]).model.to_dict(), seed=seed)


def make_inputs(path: Path, model_name: str, seed: int, batch: int, steps: int,
                n_train: int, n_val: int, epoch_batch: int, model=None) -> None:
    """The global batch, its per-step noise and the epoch phase's data (of
    ``model`` when given)."""
    model = model or build_model(model_name)
    t = 4 if model_name == "small" else 8
    rng = np.random.default_rng(seed)
    shape = (t, *model.input_dim)
    np.savez(path, model=np.array(model_name),
             x=rng.uniform(size=(batch, *shape)).astype(np.float32),
             noise=rng.normal(size=(steps, batch, model.latent_dim)).astype(np.float32),
             train=rng.uniform(size=(n_train, *shape)).astype(np.float32),
             val=rng.uniform(size=(n_val, *shape)).astype(np.float32),
             epoch_batch=np.int64(epoch_batch))


def training_config(dp: int, mp: int, batch: int, n_train: int, n_val: int,
                    chunk_steps: int = 0) -> Dict[str, Any]:
    from rlvae_tpu_torch.train import TRAINING_PRESETS

    cfg = copy.deepcopy(TRAINING_PRESETS["default"])
    cfg["trainer"].update({"devices": dp, "model_parallel": mp, "log_every_n_steps": 1 << 30,
                           "handle_preemption": False, "epoch_jit_chunk_steps": chunk_steps})
    cfg["data"]["batch_size"] = batch
    cfg["n_train_samples"], cfg["n_val_samples"] = n_train, n_val
    return cfg


def data_config(out: Path, inputs) -> Dict[str, Any]:
    from rlvae_tpu_torch.data import CYCLIC_SPRITES

    train = inputs["train"]
    return {**CYCLIC_SPRITES, "train_path": str(out / "train.npz"),
            "test_path": str(out / "val.npz"), "sequence_length": int(train.shape[1]),
            "channels": int(train.shape[2]), "image_size": list(train.shape[3:]),
            "verify_cyclicity": False, "synthetic_fallback": False}


def inputs_model(inputs, seed: int = 0):
    """The model that ``inputs.npz`` names (``model``, and ``model_config``
    when present)."""
    config = str(inputs["model_config"]) if "model_config" in inputs else ""
    return build_model(str(inputs["model"]), seed, config)


def extra_model(out: Path, name: str, seed: int = 0):
    """An ``--extra`` model: the ``create_model`` config of ``OUT/NAME.json``,
    else the model :func:`build_model` names, from its seeded init."""
    config = out / f"{name}.json"
    return build_model(name, seed, config.read_text() if config.exists() else "")


def steps_inputs(out: Path, tag: str):
    """The batch and noise of a layout's steps: ``OUT/TAG_inputs.npz`` for an
    ``--extra`` model, else the inputs'."""
    own = out / f"{tag}_inputs.npz"
    return np.load(own if own.exists() else out / "inputs.npz")


def _fresh_model(args, out: Path, device, name: str = ""):
    import torch

    if name:
        model, init = extra_model(out, name, args.seed), out / f"{name}.pt"
    else:
        model, init = inputs_model(np.load(out / "inputs.npz")), out / "init.pt"
    if init.exists():
        model.load_state_dict(torch.load(init, weights_only=True))
    return model.to(device)


def _launch_counts():
    """Every kernel wrapper's launch count."""
    from rlvae_tpu_torch.ops import iaf_kernels, metric_kernels, recon_kernels

    fns = {"chol_bundle": metric_kernels.chol_bundle, "iaf_chain_fwd": iaf_kernels.iaf_chain_fwd,
           "iaf_chain_bwd": iaf_kernels.iaf_chain_bwd, "hmc_terms": metric_kernels.hmc_terms,
           "metric_bundle": metric_kernels.metric_bundle, "g_inv": metric_kernels.g_inv,
           "decode_mse_fwd": recon_kernels.decode_mse,
           "decode_mse_bwd_dh": recon_kernels.decode_mse_bwd_dh,
           "decode_mse_bwd_dw": recon_kernels.decode_mse_bwd_dw,
           "hmc_partials": metric_kernels.hmc_partials}
    return {k: f.launches for k, f in fns.items()}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def snapshot_state(trainer) -> Dict[str, Any]:
    """The unsharded weights and Adam state (collective under TP), on the CPU."""
    return _to_cpu({"params": trainer._params(), "optimizer": trainer._adam_state()})


def snapshot(trainer, path: Path) -> None:
    """:func:`snapshot_state`, saved by rank 0: a step's starting point for
    the launcher's replay."""
    import torch

    state = snapshot_state(trainer)
    if trainer.is_main:
        torch.save(state, path)


def _same_tree(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if hasattr(tree, "cpu") else tree


class _spy_on_reduction:
    """Record into ``res`` the running statistics a step hands to
    ``reduce_over_data`` (this shard's own, before the data group's mean)
    until :meth:`undo`."""

    def __init__(self, res: Dict[str, Any]):
        from rlvae_tpu_torch.train import trainer as trainer_mod

        self.module, self.orig = trainer_mod, trainer_mod.reduce_over_data

        def spy(mesh, grads, metrics, stats):
            res.update({f"local_bn/{i}": s.detach().cpu().numpy().copy()
                        for i, s in enumerate(stats)})
            return self.orig(mesh, grads, metrics, stats)

        trainer_mod.reduce_over_data = spy

    def undo(self) -> None:
        self.module.reduce_over_data = self.orig


def run_layout(args, out: Path, inputs, device, mp: int, tag: str = "",
               model_name: str = "", epochs: int = -1) -> Dict[str, Any]:
    """The phases of one (world / mp) x mp layout on this rank, of the
    inputs' model or of the ``--extra`` model ``model_name`` (its steps
    alone); the steps' and epochs' starting states go to
    ``{tag}_{phase}_state{i}.pt`` (``tag`` ``mp{mp}`` unless given)."""
    tag = tag or f"mp{mp}"
    epochs = args.epochs if epochs < 0 else epochs
    import torch
    import torch.distributed as dist

    from rlvae_tpu_torch.data import CyclicDataModule
    from rlvae_tpu_torch.parallel.collectives import TALLY, all_reduce
    from rlvae_tpu_torch.parallel.comm_audit import param_bytes, step_plan
    from rlvae_tpu_torch.parallel.sharding import shard_batch
    from rlvae_tpu_torch.train import Trainer, get_lr
    from rlvae_tpu_torch.train.trainer import batchnorm_stats

    dp = args.world // mp
    own = steps_inputs(out, tag)
    x, noise = own["x"], own["noise"]
    n_train, n_val = len(inputs["train"]), len(inputs["val"])
    res: Dict[str, Any] = {}

    def trainer_for(batch: int, phase: str):
        model = _fresh_model(args, out, device, model_name)
        res["param_bytes"] = param_bytes(model)  # before the Trainer shards it
        cfg = training_config(dp, mp, batch, n_train, n_val)
        data = CyclicDataModule(data_config(out, inputs), seed=args.seed)
        data.setup(cfg)
        return model, Trainer(model, data, cfg, run_dir=out / f"run_{tag}_{phase}",
                              seed=args.seed, device=device)

    # -- steps -----------------------------------------------------------------
    model, trainer = trainer_for(x.shape[0], "steps")
    mesh = trainer.mesh
    xl = torch.from_numpy(np.ascontiguousarray(shard_batch(mesh, x))).to(device)
    g_noise = torch.from_numpy(noise).to(device)
    metrics, launches, step_s = [], [], []
    local_stats = _spy_on_reduction(res)  # step 1's shard statistics, before the mean
    for s in range(noise.shape[0]):
        snapshot(trainer, out / f"{tag}_steps_state{s}.pt")
        before = _launch_counts()
        TALLY.reset()
        _sync(device)
        dist.barrier()  # rank 0's snapshot is written: every rank starts the step together
        t0 = time.perf_counter()
        m = trainer.train_step(xl, g_noise[s])
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        if s == 0:
            local_stats.undo()
            res["tally"] = json.dumps(TALLY.snapshot())
            res["plan"] = json.dumps(step_plan(trainer.model, trainer.optimizer, mesh))
            res.update({f"bn/{i}": b.detach().cpu().numpy().copy()
                        for i, b in enumerate(batchnorm_stats(trainer.model))})
        launches.append({k: v - before[k] for k, v in _launch_counts().items()})
        metrics.append([float(m[k]) for k in LOSS_KEYS])
    # the step's flat all-reduce alone, for its share of the step
    flat = torch.zeros(json.loads(res["plan"])["all-reduce"]["bytes"] // 4, device=device)
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(3):
        all_reduce(flat, mesh.data_group)
    _sync(device)
    res["all_reduce_s"] = (time.perf_counter() - t0) / 3
    res.update({"metrics": np.array(metrics), "launches": json.dumps(launches),
                "step_s": np.array(step_s), "tp_layout": json.dumps(
                    dict(trainer.layout.sharded) if trainer.layout else {}),
                "data_index": mesh.data_index, "model_index": mesh.model_index})
    snapshot(trainer, out / f"{tag}_steps_state{noise.shape[0]}.pt")
    res.update({f"p/{k}": v.cpu().numpy().copy() for k, v in trainer._params().items()})
    if device.type == "cuda":  # one more step, profiled: the card's busy share of a step
        from torch.profiler import ProfilerActivity, profile

        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(xl, g_noise[-1])
            _sync(device)
            res["profiled_step_s"] = time.perf_counter() - t0
        res["busy_ms"] = sum(
            float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))
            for e in prof.key_averages() if "cuda" in str(getattr(e, "device_type", "")).lower()
        ) / 1e3
    del trainer, model

    # -- epochs ----------------------------------------------------------------
    if epochs > 0:
        eb = int(inputs["epoch_batch"])
        model, trainer = trainer_for(eb, "epochs")
        rec: Dict[str, List] = {"ex": [], "enoise": [], "lr": [], "emetrics": []}
        step = trainer.train_step

        def recorded(xb, nz, dropout=None):
            snapshot(trainer, out / f"{tag}_epochs_state{len(rec['ex'])}.pt")
            rec["ex"].append(xb.cpu().numpy())
            rec["enoise"].append(nz["eps"].cpu().numpy())
            rec["lr"].append(get_lr(trainer.optimizer))
            m = step(xb, nz, dropout)
            rec["emetrics"].append([float(m[k]) for k in LOSS_KEYS])
            return m

        trainer.train_step = recorded
        result = trainer.fit(max_epochs=epochs)
        trainer.train_step = step
        res.update({k: np.array(v) for k, v in rec.items()})
        res["val_loss"] = np.array([h["val/loss"] for h in result["history"]])
        snapshot(trainer, out / f"{tag}_epochs_state{len(rec['ex'])}.pt")
        res.update({f"e/{k}": v.cpu().numpy() for k, v in trainer._params().items()})
        # resume from the run's 'last' slot (rank 0 wrote it, every rank reads
        # it): the same unsharded weights and Adam state, bit for bit
        _, again = trainer_for(eb, "epochs")
        again.fit(max_epochs=epochs, resume=True)
        want, got = snapshot_state(trainer), snapshot_state(again)
        res["resume_equal"] = _same_tree(want, got)
        if dp > 1 and eb % dp == 0:  # the chunked epoch gathers the resident one's rows
            same = True
            for epoch in range(epochs):
                trainer.chunk_steps, trainer._rows = 0, None
                resident = [b.cpu() for b in trainer._staged_batches(epoch)]
                trainer.chunk_steps, trainer._rows = 2, None
                chunked = [b.cpu() for b in trainer._staged_batches(epoch)]
                same = same and len(resident) == len(chunked) and all(
                    torch.equal(a, b) for a, b in zip(resident, chunked))
            res["chunked_equals_resident"] = same
    return res


def run_rank(args) -> None:
    """One rank: join the world, run every layout, write rank{r}_mp{M}.npz."""
    import torch
    import torch.distributed as dist

    from rlvae_tpu_torch.parallel.launch import init_world

    faulthandler.dump_traceback_later(max(1.0, args.timeout - 10.0), exit=True)
    out = Path(args.out).resolve()
    device = init_world(args.backend, args.world, args.rank, out, args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        inputs = np.load(out / "inputs.npz")
        for mp in args.model_parallel:
            np.savez(out / f"rank{args.rank}_mp{mp}.npz",
                     **run_layout(args, out, inputs, device, mp))
        for name, mp in args.extra:
            np.savez(out / f"rank{args.rank}_{name}.npz",
                     **run_layout(args, out, inputs, device, mp, name, name, 0))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the launcher's side
# ---------------------------------------------------------------------------


def expected_rows(inputs, seed: int, dp: int, data_index: int, epoch: int) -> np.ndarray:
    """[steps, local batch, ...]: JAX's N-process staging of this data index
    (``rlvae_tpu/data/cyclic.py:133-170``, ``train/trainer.py:862-869``,
    ``parallel/multihost.py:59-73``)."""
    from rlvae_tpu_torch.parallel.multihost import host_epoch_perm

    train, bs = inputs["train"], int(inputs["epoch_batch"])
    per_host = len(train) // dp
    local = train[data_index::dp][:per_host]
    rows = local[np.random.default_rng(seed + data_index).permutation(len(local))]
    n = (len(rows) * dp) // bs
    perm = host_epoch_perm(seed, epoch, n, bs // dp, len(rows), dp)
    return rows[perm[:, data_index]]


def leaf_errors(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, Any]:
    """Leaf by leaf, |got - want| / |want| (Frobenius norms; 0 where both
    are zero) of two name -> tensor dicts: the worst leaf and its name."""
    import torch

    worst, leaf = 0.0, ""
    for k, w in want.items():
        w = w.detach().double().cpu()
        d = float(torch.linalg.vector_norm(got[k].detach().double().cpu() - w))
        n = float(torch.linalg.vector_norm(w))
        rel = d / n if n > 0 else (0.0 if d == 0 else math.inf)
        if rel > worst or not leaf:
            worst, leaf = rel, k
    return {"rel": worst, "leaf": leaf}


def whole_error(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, Any]:
    """|got - want| / |want| over every tensor of ``want`` at once (the
    Frobenius norms of the concatenations), with :func:`leaf_errors`'s
    keys (``leaf`` names the largest single contributor)."""
    import torch

    diff = {k: float(torch.linalg.vector_norm(got[k].detach().double().cpu()
                                              - w.detach().double().cpu())) ** 2
            for k, w in want.items()}
    n = sum(float(torch.linalg.vector_norm(w.detach().double())) ** 2 for w in want.values())
    d = sum(diff.values())
    return {"rel": math.sqrt(d / n) if n > 0 else (0.0 if d == 0 else math.inf),
            "leaf": max(diff, key=diff.get) if diff else ""}


def replay(out: Path, phase: str, model, batches, noises, metrics, tol, lrs=None,
           device: str = "cpu") -> Dict[str, Any]:
    """Each recorded step again, in one process of plain PyTorch on
    ``device``, from the state the world held before it
    (``{phase}_state{i}.pt``) on the global batch and noise: the worst loss
    relative error, step 1's grad_norm relative error (``grad_norm_rel``;
    each step's in ``grad_norm_rel_per_step``), the worst leaf's relative
    error of Adam's first moment after the step against the world's
    (``exp_avg_rel`` and its leaf: the moment is 0.9 x the saved one plus
    0.1 x the step's gradient, so a wrong gradient of any one leaf shows
    there), the relative error of the weights' update over the whole model
    (``update_rel``: another learning rate or a doubled step reads 1), and
    the largest weight difference.  The held figures take every leaf at step 1 and the
    nets' (every leaf but the flows') after it: from a trained state the
    reference-init flows amplify the rounding of another summation order
    (ROADMAP C3); the worst over every leaf of each step is reported in
    ``*_rel_per_step``.  ``bitwise`` when every step gave the world's
    bits."""
    import torch

    from rlvae_tpu_torch.train import (TRAINING_PRESETS, load_adam_state, make_optimizer,
                                       make_train_step, set_lr)
    from rlvae_tpu_torch.train.optim import adam_state

    opt_cfg = TRAINING_PRESETS["default"]["optimizer"]
    worst = {"loss_rel": 0.0, "grad_norm_rel_per_step": [], "param_max_abs": 0.0,
             "bitwise": True}
    for key in ("exp_avg", "update"):
        worst.update({f"{key}_rel_per_step": [], f"{key}_rel": 0.0, f"{key}_leaf": ""})
    model.to(device)
    names = [(k, p) for k, p in model.named_parameters()]
    for i, (xb, nz) in enumerate(zip(batches, noises)):
        state = torch.load(out / f"{phase}_state{i}.pt", weights_only=True, map_location=device)
        model.load_state_dict(state["params"])
        opt = make_optimizer(model.parameters(), opt_cfg["lr"], opt_cfg["weight_decay"])
        if state["optimizer"]["state"]:
            load_adam_state(model, opt, state["optimizer"])
        if lrs is not None:
            set_lr(opt, float(lrs[i]))
        m = make_train_step(model, opt)(torch.from_numpy(np.ascontiguousarray(xb)).to(device),
                                        torch.from_numpy(np.ascontiguousarray(nz)).to(device))
        nxt = torch.load(out / f"{phase}_state{i + 1}.pt", weights_only=True)
        pairs = {"exp_avg": ({k: v["exp_avg"] for k, v in nxt["optimizer"]["state"].items()},
                             {k: v["exp_avg"] for k, v in adam_state(model, opt)["state"].items()}),
                 "update": ({k: nxt["params"][k].cpu() - state["params"][k].cpu()
                             for k, _ in names},
                            {k: p.detach().cpu() - state["params"][k].cpu() for k, p in names})}
        for key, (world_side, plain) in pairs.items():
            # the first moment leaf by leaf, the update over the whole model
            errors = leaf_errors if key == "exp_avg" else whole_error
            every = errors(world_side, plain)
            worst[f"{key}_rel_per_step"].append(every["rel"])
            held = every if i == 0 else errors(
                world_side, {k: v for k, v in plain.items() if not k.startswith("flows.")})
            if held["rel"] >= worst[f"{key}_rel"]:
                worst[f"{key}_rel"], worst[f"{key}_leaf"] = held["rel"], held["leaf"]
        got = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
        want = {k: v.numpy() for k, v in nxt["params"].items()}
        worst["bitwise"] = bool(worst["bitwise"] and float(m["loss"]) == metrics[i][0] and float(
            m["grad_norm"]) == metrics[i][5] and all(np.array_equal(got[k], w)
                                                    for k, w in want.items()))
        worst["loss_rel"] = max(worst["loss_rel"],
                                abs(metrics[i][0] - float(m["loss"])) / abs(float(m["loss"])))
        worst["grad_norm_rel_per_step"].append(
            abs(metrics[i][5] - float(m["grad_norm"])) / abs(float(m["grad_norm"])))
        worst["param_max_abs"] = max(worst["param_max_abs"], *(
            float(np.abs(got[k].astype(np.float64) - w).max(initial=0.0))
            for k, w in want.items()))
    worst["grad_norm_rel"] = worst["grad_norm_rel_per_step"][0]
    return worst


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(),
                                                                         1e-30))


def _within(worst: Dict[str, Any], tol: Dict[str, float]) -> bool:
    """Every step's loss, step 1's grad_norm (as JAX's parity test holds
    it), and the first moment and update of every leaf at step 1 and of
    the nets' leaves after it (:func:`replay`).  A later step's grad_norm
    and flows are reported, not held: from a trained state the
    reference-init flows amplify the rounding of another summation order
    (ROADMAP C3; the default preset's flow biases read 0.23 in the first
    moment at step 2 on the CPU)."""
    return (worst["loss_rel"] <= tol["loss_rtol"]
            and worst["grad_norm_rel"] <= tol["grad_norm_rtol"]
            and worst["exp_avg_rel"] <= tol["exp_avg_rel"]
            and worst["update_rel"] <= tol["update_rel"])


def check(out: Path, world: int, model_parallel: int, seed: int, epochs: int,
          device: str = "cpu", tag: str = "", model_name: str = "") -> Dict[str, Any]:
    """Hold the ranks' records against plain PyTorch in one process on
    ``device`` (the card's first device for ``cuda``)."""
    import torch

    from rlvae_tpu_torch.train.trainer import batchnorm_stats

    dp = world // model_parallel
    inputs = np.load(out / "inputs.npz")
    tag = tag or f"mp{model_parallel}"
    own = steps_inputs(out, tag)
    ranks = [dict(np.load(out / f"rank{r}_{tag}.npz")) for r in range(world)]
    tol = TOL if device == "cpu" else CARD_TOL
    summary: Dict[str, Any] = {"world": world, "mesh": {"data": dp, "model": model_parallel},
                               "model": model_name or str(inputs["model"]), "tolerances": tol,
                               "replayed_on": device}
    failures: List[str] = []
    lead = ranks[0]
    for key in ("metrics", *[k for k in lead if k.startswith(("p/", "e/", "bn/"))]):
        if any(not np.array_equal(lead[key], r[key]) for r in ranks[1:]):
            failures.append(f"the ranks' {key} differ")
            break
    model = extra_model(out, model_name) if model_name else inputs_model(inputs)
    has_bn = bool(batchnorm_stats(model))

    # -- the steps: BatchNorm statistics, or each step against the plain one --
    if has_bn:
        # step 1's running statistics: the mean of the shards' own (each
        # rank's, recorded before the reduction; and, for a model without
        # dropout, a plain train forward of each shard from the same state)
        n_stats = len(batchnorm_stats(model))
        groups = [ranks[d * model_parallel] for d in range(dp)]
        shard_stats = [[g[f"local_bn/{i}"] for i in range(n_stats)] for g in groups]
        dropout = any(getattr(net, "dropout", 0.0) for net in (model.encoder, model.decoder))
        if not dropout:
            init = torch.load(out / f"{tag}_steps_state0.pt", weights_only=True)["params"]
            for d, (xs, ns) in enumerate(zip(np.split(own["x"], dp),
                                             np.split(own["noise"][0], dp))):
                model.load_state_dict(init)
                with torch.no_grad():
                    model(torch.from_numpy(xs), torch.from_numpy(ns), train=True)
                plain = [b.numpy() for b in batchnorm_stats(model)]
                summary["bn_shard_vs_plain_rel"] = max(
                    summary.get("bn_shard_vs_plain_rel", 0.0),
                    *(_rel(shard_stats[d][i], plain[i]) for i in range(n_stats)))
        bn_err = max(_rel(lead[f"bn/{i}"], np.mean([st[i] for st in shard_stats], 0))
                     for i in range(n_stats))
        summary["bn_vs_shard_mean_rel"] = bn_err
        if bn_err > 1e-6 or summary.get("bn_shard_vs_plain_rel", 0.0) > tol["bn_rel"]:
            failures.append(f"BatchNorm statistics are not the shards' mean ({bn_err}, "
                            f"{summary.get('bn_shard_vs_plain_rel')})")
    else:
        n = len(own["noise"])
        worst = replay(out, f"{tag}_steps", model, [own["x"]] * n,
                       own["noise"], lead["metrics"], tol, device=device)
        summary["steps_vs_plain"] = worst
        if not _within(worst, tol):
            failures.append(f"DP steps vs the plain step on the whole batch: {worst}")

    # -- the first step's collectives --------------------------------------------
    tally, plan = json.loads(str(lead["tally"])), json.loads(str(lead["plan"]))
    pbytes = int(lead["param_bytes"])
    total = sum(v["bytes"] for v in tally.values())
    summary.update({"collectives": tally, "plan": plan, "param_bytes": pbytes,
                    "total_bytes": total})
    if model_parallel == 1:
        ok = (tally["all-gather"]["bytes"] == 0
              and pbytes <= tally["all-reduce"]["bytes"] <= 1.25 * pbytes
              and tally["all-reduce"] == plan["all-reduce"])
    elif model_name:  # another model's layers and kernels: the plan, and some gathers
        ok = (tally["all-gather"]["bytes"] > 0
              and tally["all-reduce"]["bytes"] >= plan["all-reduce"]["bytes"])
    else:  # JAX's invariants of its audit model
        ok = (0 < total < pbytes and tally["all-gather"]["bytes"] < pbytes / 2
              and tally["all-reduce"]["bytes"] >= plan["all-reduce"]["bytes"])
    if not ok:
        failures.append(f"collectives of one step off the plan: {tally} vs {plan}, "
                        f"{pbytes} parameter bytes")
    summary["step_s"] = [float(np.median(r["step_s"][1:] if len(r["step_s"]) > 1
                                         else r["step_s"])) for r in ranks]
    summary["all_reduce_s"] = [float(r["all_reduce_s"]) for r in ranks]
    if "busy_ms" in lead:
        summary["busy_ms"] = [float(r["busy_ms"]) for r in ranks]
        summary["profiled_step_s"] = [float(r["profiled_step_s"]) for r in ranks]
    summary["launches"] = [json.loads(str(r["launches"])) for r in ranks]
    summary["tp_layout"] = json.loads(str(lead["tp_layout"]))

    # -- the epochs: rows, chunked == resident, the replay -------------------------
    if epochs > 0:
        groups = [ranks[d * model_parallel] for d in range(dp)]
        bs = int(inputs["epoch_batch"])
        staged = dp > 1 and bs % dp == 0
        rows_ok = all(np.array_equal(np.concatenate(
            [expected_rows(inputs, seed, dp, d, e) for e in range(epochs)]), g["ex"])
            for d, g in enumerate(groups)) if staged else None
        summary["rows_equal_host_epoch_perm"] = rows_ok
        summary["resume_equal"] = all(bool(r["resume_equal"]) for r in ranks)
        if not summary["resume_equal"]:
            failures.append("a rank resumed from 'last' to other weights or Adam state")
        summary["chunked_equals_resident"] = (all(bool(r["chunked_equals_resident"])
                                                  for r in ranks) if staged else None)
        if rows_ok is False:
            failures.append("a rank's epoch rows differ from its host_epoch_perm column")
        if summary["chunked_equals_resident"] is False:
            failures.append("the chunked epoch's batches differ from the resident one's")
        n = len(lead["ex"])
        summary["epochs"] = {"steps": n, "val_loss": lead["val_loss"].tolist()}
        if not has_bn:
            worst = replay(out, f"{tag}_epochs", model,
                           [np.concatenate([g["ex"][s] for g in groups]) for s in range(n)],
                           [np.concatenate([g["enoise"][s] for g in groups]) for s in range(n)],
                           lead["emetrics"], tol, lead["lr"], device=device)
            summary["epochs"]["vs_replay"] = worst
            if not _within(worst, tol):
                failures.append(f"epochs vs the single-process replay: {worst}")
            # the last validation, split over the data group, against one process
            val = _plain_validation(out, inputs, model, torch.load(
                out / f"{tag}_epochs_state{n}.pt", weights_only=True,
                map_location=device)["params"], seed, epochs - 1, device)
            summary["epochs"]["val_loss_vs_plain_rel"] = abs(
                float(lead["val_loss"][-1]) - val) / abs(val)
            if summary["epochs"]["val_loss_vs_plain_rel"] > tol["loss_rtol"]:
                failures.append(f"validation vs one process: {lead['val_loss'][-1]} vs {val}")
    summary["failures"] = failures
    summary["ok"] = not failures
    return summary


def _plain_validation(out: Path, inputs, model, params, seed: int, epoch: int,
                      device: str) -> float:
    """The validation loss of ``params`` over the inputs' validation rows,
    as a Trainer outside any world computes it."""
    from rlvae_tpu_torch.data import CyclicDataModule
    from rlvae_tpu_torch.train import Trainer

    cfg = training_config(1, 1, int(inputs["epoch_batch"]), len(inputs["train"]),
                          len(inputs["val"]))
    data = CyclicDataModule(data_config(out, inputs), seed=seed, process_index=0,
                            process_count=1)
    data.setup(cfg)
    trainer = Trainer(model, data, cfg, run_dir=out / "run_plain_validation", seed=seed,
                      device=device)
    trainer._load_params(params)
    return trainer.evaluate("val", epoch, weights="live")["loss"]


def check_all(out: Path, world: int, layouts, seed: int, epochs: int,
              device: str = "cpu", extra=()) -> Dict[str, Any]:
    """:func:`check` of every layout, under the model-axis size as a key,
    and of every ``--extra`` model's steps under its name."""
    results = {str(mp): check(out, world, mp, seed, epochs, device) for mp in layouts}
    for name, mp in extra:
        results[name] = check(out, world, mp, seed, 0, device, name, name)
    return {"ok": all(r["ok"] for r in results.values()), "world": world, "layouts": results}


def launch(args) -> int:
    from rlvae_tpu_torch.parallel.launch import check_backend, rank_logs, spawn_ranks

    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    for mp in [*args.model_parallel, *(m for _, m in args.extra)]:
        if args.world < 1 or mp < 1 or args.world % mp:
            raise SystemExit(f"--world {args.world} must be a multiple of --model-parallel {mp}")
    check_backend(args.backend, args.world, args.device)
    if not (out / "inputs.npz").exists():
        make_inputs(out / "inputs.npz", args.model, args.seed, batch=args.batch,
                    steps=args.steps, n_train=args.train_rows, n_val=args.batch,
                    epoch_batch=args.batch)
    for name, _ in args.extra:
        if not (out / f"{name}_inputs.npz").exists():
            make_inputs(out / f"{name}_inputs.npz", name, args.seed, batch=args.batch,
                        steps=args.steps, n_train=0, n_val=0, epoch_batch=args.batch,
                        model=extra_model(out, name))
    inputs = np.load(out / "inputs.npz")
    for tag, mp in [*((f"mp{m}", m) for m in args.model_parallel), *args.extra]:
        rows = steps_inputs(out, tag)["x"].shape[0]
        if rows % (args.world // mp):
            raise SystemExit(f"the batch of {rows} rows of {tag} does not divide over "
                             f"the data axis ({args.world // mp})")
    np.savez(out / "train.npz", sequences=inputs["train"])
    np.savez(out / "val.npz", sequences=inputs["val"])
    for stale in [out / "summary.json", *out.glob("rank*.npz"), *out.glob("*_state*.pt")]:
        stale.unlink(missing_ok=True)
    argv = ["--world", str(args.world),
            "--model-parallel", ",".join(str(m) for m in args.model_parallel),
            "--device", args.device, "--backend", args.backend, "--out", str(out),
            "--timeout", str(args.timeout), "--seed", str(args.seed),
            "--epochs", str(args.epochs),
            "--extra", ",".join(f"{n}@{m}" for n, m in args.extra)]
    failed = spawn_ranks("rlvae_tpu_torch.parallel.dp_verify", argv, args.world, out,
                         args.timeout)
    if failed:
        print(rank_logs(out, args.world), file=sys.stderr)
        print(json.dumps({"ok": False, "failed": failed}))
        return 1
    summary = check_all(out, args.world, args.model_parallel, args.seed, args.epochs,
                        args.device, args.extra)
    (out / "summary.json").write_text(json.dumps(summary))
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


def main(argv=None) -> int:
    from rlvae_tpu_torch.parallel.launch import default_backend

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--model-parallel", default="1",
                        help="ranks per model group; a comma list runs each layout in turn")
    parser.add_argument("--out", required=True, help="directory for inputs, store and results")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                        help="gloo on the CPU, nccl on the card unless given")
    parser.add_argument("--model", default="small",
                        help="small, a models.PRESETS name or a conf/model name (inputs.npz)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=16, help="global batch (inputs.npz)")
    parser.add_argument("--steps", type=int, default=3, help="train steps (inputs.npz)")
    parser.add_argument("--train-rows", type=int, default=32, help="epoch rows (inputs.npz)")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--extra", default="",
                        help="NAME@M,...: also the steps of these models in the "
                             "(world / M) x M layout (a BatchNorm model's running statistics "
                             "against the shards' mean, any other's against the replay)")
    parser.add_argument("--timeout", type=float, default=300.0,
                        help="seconds for the whole run, every rank included")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    args.backend = args.backend or default_backend(args.device)
    args.model_parallel = [int(m) for m in str(args.model_parallel).split(",")]
    args.extra = [(name, int(mp or 1)) for name, _, mp in
                  (e.partition("@") for e in args.extra.split(",") if e)]
    if args.rank is not None:
        run_rank(args)
        return 0
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
