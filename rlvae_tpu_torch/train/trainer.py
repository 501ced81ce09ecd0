"""Training loop, on one device or over a data-parallel world.

Port of ``rlvae_tpu/train/trainer.py``'s per-step path and its sharded
epoch:

- :func:`make_train_step` is ``_step_body`` (``trainer.py:78-111``): the
  forward with ``train=True``, ``loss.backward()``, the global gradient norm,
  and one Adam step with coupled weight decay.  Its metrics carry the keys of
  ``trainer.py:94-103``.  With a ``mesh`` it is the step with
  ``pmean_axis``: one flat all-reduce over the data group carries every
  gradient, the loss terms and the BatchNorm running statistics, divided by
  the group's size (the gradients' and metrics' mean; the running
  statistics averaged, while the forward's batch statistics stay
  per-shard, not ``SyncBatchNorm``), and the gradient norm is taken after
  it.
- :func:`make_eval_step` is ``_eval_metrics`` (``trainer.py:253-262``): the
  evaluation forward (no gradients) with ``compute_metrics=True``, so it
  returns the loss terms plus the analysis metrics of
  ``losses.additional_metrics``.
- :class:`Trainer` runs epochs of train steps, a validation pass per epoch
  (batch-size-weighted means), the plateau learning-rate schedule and early
  stopping, and keeps a run directory (``trainer.py:358-705``): the
  checkpoint slots ``best`` and ``last`` (:mod:`.checkpoints`), the metrics
  files (:class:`~rlvae_tpu_torch.utils.logging.MetricsLogger`), resume from
  ``last``, and a stop at the next epoch boundary on SIGTERM or a
  ``stop_flag``.  It fires JAX's callback events (:mod:`.callbacks`), calls
  ``viz_hook`` at every epoch end, adds ``StepTimer`` keys to every logged
  step record (the logged step waits for the card, as JAX's
  ``block_until_ready`` does), traces epoch 0 into ``run_dir/profile`` with
  ``trainer.profile`` and checks every step for NaN/Inf with
  ``debug_nan_checks`` (:mod:`rlvae_tpu_torch.utils.debug`).

The trainer config's device keys (:func:`resolve_trainer_device`):
``trainer.accelerator`` ``auto``, ``gpu`` or ``cuda`` is the card (and
raises without one), ``cpu`` the CPU; ``tpu`` raises.

Data and model parallelism (:func:`resolve_trainer_mesh`): one process per
device in an initialised ``torch.distributed`` world (``python -m
rlvae_tpu_torch.train --world N`` launches one), laid out as the data x
model :class:`~rlvae_tpu_torch.parallel.mesh.Mesh` with
``trainer.model_parallel`` ranks per model group.  ``trainer.devices``
(:func:`~rlvae_tpu_torch.parallel.mesh.resolve_num_devices`) must name the
world's data axis; outside a world ``devices`` > 1 or ``model_parallel`` > 1
raise, naming the launcher.  In a world the trainer broadcasts rank 0's
weights, shards the big kernels over the model axis
(:func:`~rlvae_tpu_torch.parallel.sharding.shard_params`) and steps with
the mesh.  Each rank's data module holds its strided rows; a data axis of
more than one rank walks its own column of ``host_epoch_perm`` over its
staging-permuted rows (``trainer.py:818-880``), resident on its device, or
gathered on the host per ``epoch_jit_chunk_steps`` steps: the same batches
either way.  A global batch size that the data axis does not divide takes
the per-step loop over the rank's rows at batch ``size // data axis`` (the
remainder dropped).  The posterior noise and dropout masks come from a
generator seeded with ``seed + data_index * 2**32`` (the ranks of one model
group draw the same), so a world of one rank draws what one process does.
Validation splits each batch over the data group (noise drawn for the
whole batch, each rank using its rows) and reduces the batch-size-weighted
sums: the loss terms are the whole batch's; the analysis metrics that are
population statistics (the latent variance, the spread of log det G^{-1},
the conditioning of the first 32 rows) become the row-weighted mean of the
shards'.  Rank 0 alone writes checkpoints, ``metrics.jsonl``,
``summary.json``, the profile and wandb; checkpoints hold the unsharded
weights and Adam moments, and ``resume`` restores on every rank.  A stop
request on any rank stops every rank at the same epoch boundary.
``epoch_jit`` and ``eval_jit`` are accepted (a captured epoch is ROADMAP
A3).

The posterior noise (ε, and t for the ``geodesic`` posterior method; see
``RlVAE.draw_posterior_noise``) is drawn from a ``torch.Generator`` on the
model's device, seeded from the trainer's seed; the step functions take it
as an argument (the mapping, or ε alone), so tests can hand both frameworks
the same numbers.  Dropout masks come from the same generator, after each
step's noise.  A train step moves the nets' BatchNorm running statistics;
validation and ``evaluate`` run the nets in eval mode, on the running
statistics, without dropout.  The checkpoint slots' ``params`` hold the
model's whole state dict, BatchNorm buffers included.
"""

from __future__ import annotations

import contextlib
import math
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.utils import parametrize

from rlvae_tpu_torch.data.cyclic import CyclicDataModule, batch_iterator
from rlvae_tpu_torch.device import DeviceLike, resolve_device
from rlvae_tpu_torch.models.rlvae import RlVAE
from rlvae_tpu_torch.nets.layers import BatchNorm
from rlvae_tpu_torch.parallel.collectives import all_reduce
from rlvae_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    is_main_process,
    resolve_num_devices,
    world_initialized,
)
from rlvae_tpu_torch.parallel.multihost import (
    epoch_perm,
    host_epoch_perm,
    stage_dataset,
    staging_perm,
    usable_local_rows,
)
from rlvae_tpu_torch.parallel.sharding import TPLayout, full_name, replicate, shard_params
from rlvae_tpu_torch.train.callbacks import CallbackHandler, TrainingCallback
from rlvae_tpu_torch.train.checkpoints import CheckpointManager
from rlvae_tpu_torch.train.optim import (
    EarlyStopping,
    PlateauScheduler,
    adam_state,
    get_lr,
    load_adam_state,
    make_optimizer,
    set_lr,
)
from rlvae_tpu_torch.utils.debug import add_nan_checks
from rlvae_tpu_torch.utils.logging import MetricsLogger
from rlvae_tpu_torch.utils.profiling import StepTimer, trace

Metrics = Dict[str, torch.Tensor]
Noise = Union[torch.Tensor, Mapping[str, torch.Tensor]]
LOSS_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty")
EVAL_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss")
ACCELERATORS = {"auto": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}
LAUNCHER = "python -m rlvae_tpu_torch.train --world N [--model-parallel M]"


def _refuse_without_world(trainer_cfg: Mapping[str, Any]) -> None:
    devices = trainer_cfg.get("devices", 1)
    mp = int(trainer_cfg.get("model_parallel", 1))
    if not world_initialized() and (resolve_num_devices(devices) > 1 or mp > 1):
        raise ValueError(
            f"training.trainer.devices={devices!r}, model_parallel={mp}: the port runs one "
            "process per device, so this needs an initialised torch.distributed world of "
            f"devices x model_parallel ranks; launch it with `{LAUNCHER}`")


def resolve_trainer_device(trainer_cfg: Mapping[str, Any],
                           device: DeviceLike = None) -> torch.device:
    """The device a trainer config asks for (``device``, when given, wins
    over ``trainer.accelerator``); raises for what the port does not run."""
    accelerator = str(trainer_cfg.get("accelerator", "auto")).lower()
    if accelerator not in ACCELERATORS:
        raise ValueError(f"training.trainer.accelerator {accelerator!r}: the port runs on "
                         f"{sorted(ACCELERATORS)} (a TPU is the JAX package's)")
    _refuse_without_world(trainer_cfg)
    return resolve_device(ACCELERATORS[accelerator] if device is None else device)


def resolve_trainer_mesh(trainer_cfg: Mapping[str, Any]) -> Optional[Mesh]:
    """The data x model mesh of the initialised world (None outside one,
    where ``devices`` > 1 or ``model_parallel`` > 1 raise); ``devices``
    must resolve to the world's data axis."""
    _refuse_without_world(trainer_cfg)
    if not world_initialized():
        return None
    mp = int(trainer_cfg.get("model_parallel", 1))
    mesh = create_mesh(mp)
    devices = trainer_cfg.get("devices", 1)
    if resolve_num_devices(devices, mesh) != mesh.dp:
        raise ValueError(
            f"training.trainer.devices={devices!r} but the world of {dist.get_world_size()} "
            f"ranks at model_parallel={mp} has a data axis of {mesh.dp}: set devices to "
            f"{mesh.dp} (or 'all')")
    return mesh


def noise_seed(seed: int, data_index: int) -> int:
    """The seed of a rank's noise generator: ``seed`` at data index 0."""
    return seed + (data_index << 32)


def local_noise(mesh: Mesh, noise: Noise, rows: int) -> Noise:
    """This rank's rows of the noise: a tensor (or each tensor of a
    mapping) of ``rows`` rows is already local; one of ``rows`` x data axis
    rows is the global batch's, cut by data index."""

    def cut(v: torch.Tensor) -> torch.Tensor:
        if v.shape[0] == rows:
            return v
        if v.shape[0] == rows * mesh.dp:
            return v[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        raise ValueError(f"noise of {v.shape[0]} rows for a local batch of {rows} "
                         f"over a data axis of {mesh.dp}")

    if isinstance(noise, torch.Tensor):
        return cut(noise)
    return {k: cut(v) for k, v in noise.items()}


def batchnorm_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    """The running statistics of every BatchNorm layer, in module order."""
    return [b for m in model.modules() if isinstance(m, BatchNorm) for b in (m.mean, m.var)]


def reduce_over_data(mesh: Mesh, grads: List[torch.Tensor], metrics: List[torch.Tensor],
                     stats: List[torch.Tensor]) -> List[torch.Tensor]:
    """The data group's mean of the gradients, the loss terms and the
    running statistics, in one flat all-reduce; gradients and statistics
    are overwritten in place, the loss terms returned."""
    flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack(metrics).float()]
                     + [s.reshape(-1) for s in stats])
    all_reduce(flat, mesh.data_group).div_(mesh.dp)
    parts = torch.split(flat, [g.numel() for g in grads] + [len(metrics)]
                        + [s.numel() for s in stats])
    for t, v in zip(grads, parts[:len(grads)]):
        t.copy_(v.view_as(t))
    for t, v in zip(stats, parts[len(grads) + 1:]):
        t.copy_(v.view_as(t))
    return list(parts[len(grads)])


def make_train_step(model: RlVAE, optimizer: torch.optim.Optimizer,
                    nan_checks: bool = False,
                    generator: Optional[torch.Generator] = None,
                    mesh: Optional[Mesh] = None,
                    layout: Optional[TPLayout] = None) -> Callable[..., Metrics]:
    """``step(batch, noise, dropout=None) -> metrics``: one
    forward/backward/Adam update.  The nets run in train mode: BatchNorm
    layers move their running statistics once per step (buffers, which the
    optimizer never sees; their scale and bias are parameters, decayed as
    in JAX), and dropout draws its masks from ``dropout`` (a
    ``DropoutMasks`` or a generator), else from ``generator``.  With
    ``nan_checks`` every step checks its loss terms, gradients and
    parameters and raises ``FloatingPointError`` at the first NaN or Inf.

    Every parameter gets a gradient tensor before the update, zeros where the
    loss does not reach it (at n_obs=8 the 8th flow is unused): the JAX
    optimizer still decays such a parameter and advances its Adam moments,
    while ``torch.optim.Adam`` would skip a parameter whose ``.grad`` is None.
    The metrics stay on the device as 0-d tensors.

    With ``mesh`` (the data-parallel step) ``batch`` is this rank's rows and
    ``noise`` this rank's rows or the global batch's (:func:`local_noise`);
    the gradients, loss terms and running statistics are averaged over the
    data group (:func:`reduce_over_data`) before the norm and the update.
    With ``layout`` (:func:`~rlvae_tpu_torch.parallel.sharding.shard_params`)
    the sharded parameters' squared norms are summed over the model group,
    and each gathered weight is gathered once per step.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    stats = batchnorm_stats(model) if mesh is not None else []
    sharded = {id(p) for n, p in model.named_parameters()
               if layout is not None and full_name(n) in layout.sharded}

    def norm(grads) -> torch.Tensor:
        if not sharded:
            return torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        sq = [torch.stack([g.square().sum() for p, g in zip(params, grads) if (id(p) in sharded)
                           == part]).sum() for part in (False, True)]
        return torch.sqrt(sq[0] + all_reduce(sq[1], mesh.model_group))

    def step(batch: torch.Tensor, noise: Noise, dropout=None) -> Metrics:
        if mesh is not None:
            noise = local_noise(mesh, noise, batch.shape[0])
        optimizer.zero_grad(set_to_none=True)
        with parametrize.cached() if sharded else contextlib.nullcontext():
            out = model(batch, noise, train=True,
                        dropout=generator if dropout is None else dropout)
            out.loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        losses = [out[k].detach() for k in LOSS_KEYS]
        if mesh is not None:
            losses = reduce_over_data(mesh, [p.grad for p in params], losses, stats)
        grad_norm = norm([p.grad for p in params])
        optimizer.step()
        metrics = dict(zip(LOSS_KEYS, losses))
        metrics["grad_norm"] = grad_norm
        return metrics

    return add_nan_checks(step, model) if nan_checks else step


def make_eval_step(model: RlVAE) -> Callable[..., Metrics]:
    """``step(batch, noise) -> metrics``: the loss terms and the analysis
    metrics of one evaluation forward."""

    @torch.no_grad()
    def step(batch: torch.Tensor, noise: Noise) -> Metrics:
        out = model(batch, noise, train=False, compute_metrics=True)
        return {**{k: out[k] for k in EVAL_KEYS}, **out["metrics"]}

    return step


class Trainer:
    """Epoch-driven trainer with validation, plateau LR, early stopping,
    checkpoints, preemption, callbacks and an epoch-end ``viz_hook``.

    ``run_dir`` receives ``checkpoints/{best,last}`` with the
    ``model_config.json`` sidecar, ``metrics.jsonl`` and ``summary.json``
    (``outputs/run`` by default, as in JAX: pass a directory of your own),
    and ``profile/`` with ``trainer.profile``.  ``best`` is written at every
    improved validation loss, ``last`` when ``fit`` returns, a stop by
    SIGTERM or ``stop_flag`` included.  With ``trainer.handle_preemption``
    (on by default) a SIGTERM received on the main thread during ``fit``
    stops training at the next epoch boundary; ``stop_flag()`` is polled
    before and after every epoch and does the same.  ``device`` overrides
    the config's ``trainer.accelerator`` (:func:`resolve_trainer_device`).
    ``viz_hook(epoch=, model=, variables=, trainer=)`` is called after every
    epoch's validation, with the model's state dict as ``variables``.
    """

    def __init__(self, model: RlVAE, data_module: CyclicDataModule,
                 training_config: Mapping[str, Any], run_dir: Union[str, Path] = "outputs/run",
                 logger: Optional[MetricsLogger] = None,
                 viz_hook: Optional[Callable[..., Any]] = None, seed: int = 42,
                 callbacks: Optional[List[TrainingCallback]] = None,
                 stop_flag: Optional[Callable[[], bool]] = None, device: DeviceLike = None):
        self.cfg = dict(training_config)
        trainer_cfg = self.cfg.get("trainer", {})
        self.device = resolve_trainer_device(trainer_cfg, device)
        self.mesh = resolve_trainer_mesh(trainer_cfg)
        self.model = model.to(self.device)
        self.data = data_module
        self.layout: Optional[TPLayout] = None
        if self.mesh is not None:
            shard = (getattr(data_module, "process_index", None),
                     getattr(data_module, "process_count", None))
            if self.mesh.dp > 1 and shard != (self.mesh.data_index, self.mesh.dp):
                raise ValueError(
                    f"the data module holds the rows of data index {shard[0]} of {shard[1]}, "
                    f"this rank is {self.mesh.data_index} of {self.mesh.dp}: set it up with "
                    "this training config inside the world")
            replicate(self.mesh, self.model)
            # the fused decode+MSE kernel reads the decoder's output layer whole
            gather = ("decoder.out",) if getattr(model, "fused_decode_mse", False) else ()
            self.layout = shard_params(self.mesh, self.model, gather=gather)
        self.is_main = is_main_process()
        self.seed = seed
        self.run_dir = Path(run_dir)
        self.logger = logger or MetricsLogger(self.run_dir)
        self.viz_hook = viz_hook
        self.callbacks = CallbackHandler(callbacks)
        self.stop_flag = stop_flag

        self.max_epochs = int(trainer_cfg.get("max_epochs", 30))
        self.log_every = int(trainer_cfg.get("log_every_n_steps", 10))
        self.profile = bool(trainer_cfg.get("profile", False))
        self.chunk_steps = int(trainer_cfg.get("epoch_jit_chunk_steps", 0))
        self._rows = None  # a data-parallel rank's staged rows
        self.handle_preemption = bool(trainer_cfg.get("handle_preemption", True))
        self._preempted = False
        opt_cfg = self.cfg.get("optimizer", {})
        self.optimizer = make_optimizer(
            self.model.parameters(), float(opt_cfg.get("lr", 1e-3)),
            float(opt_cfg.get("weight_decay", 0.0)),
        )
        self.scheduler = PlateauScheduler.from_config(self.cfg.get("scheduler", {}))
        self.early_stopping = EarlyStopping.from_config(self.cfg.get("early_stopping", {}))
        self.checkpoints = CheckpointManager(self.run_dir / "checkpoints",
                                             self.model.get_model_summary())
        self.generator = torch.Generator(device=self.device).manual_seed(self._noise_seed())
        self.train_step = make_train_step(
            self.model, self.optimizer, nan_checks=bool(self.cfg.get("debug_nan_checks", False)),
            generator=self.generator, mesh=self.mesh, layout=self.layout)
        self.eval_step = make_eval_step(self.model)
        self.history: List[Dict[str, float]] = []  # one summary per epoch
        self.callbacks.on_init_end(self.cfg, trainer=self)

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _noise_seed(self) -> int:
        return noise_seed(self.seed, 0 if self.mesh is None else self.mesh.data_index)

    def _barrier(self) -> None:
        """In a world, wait until every rank is here (after rank 0 wrote a
        checkpoint that the others may read next)."""
        if self.mesh is not None:
            dist.barrier()

    # -- checkpoint state -------------------------------------------------------

    def _params(self) -> Dict[str, torch.Tensor]:
        """The model's whole state dict, unsharded (collective under TP)."""
        state = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        return state if not self.layout or not self.layout.sharded else \
            self.layout.gather_state(state)

    def _load_params(self, full: Mapping[str, torch.Tensor]) -> None:
        if self.layout and self.layout.sharded:
            full = self.layout.local_state(dict(full), self.model.state_dict().keys())
        self.model.load_state_dict(full)

    def _adam_state(self) -> Dict[str, Any]:
        state = adam_state(self.model, self.optimizer)
        if self.layout and self.layout.sharded:
            names = list(state["state"])
            moments = {k: self.layout.gather_state({n: state["state"][n][k] for n in names})
                       for k in ("step", "exp_avg", "exp_avg_sq")}
            state["state"] = {full_name(n): {k: moments[k][full_name(n)] for k in moments}
                              for n in names}
        return state

    def _load_adam_state(self, state: Mapping[str, Any]) -> None:
        if self.layout and self.layout.sharded:
            names = [n for n, _ in self.model.named_parameters()
                     if full_name(n) in state["state"]]
            moments = {k: self.layout.local_state(
                {full_name(n): state["state"][full_name(n)][k] for n in names}, names)
                for k in ("step", "exp_avg", "exp_avg_sq")}
            state = {"lr": state["lr"],
                     "state": {n: {k: moments[k][n] for k in moments} for n in names}}
        load_adam_state(self.model, self.optimizer, state)

    # -- batches ----------------------------------------------------------------

    def _train_batches(self, epoch: int) -> Iterator[torch.Tensor]:
        """This rank's batches of one epoch, on its device (module docstring)."""
        if self.mesh is None or self.mesh.dp == 1:
            for batch in self.data.train_batches(epoch):
                yield self._to_device(batch)
            return
        bs, dp = self.data.batch_size, self.mesh.dp
        if bs < dp:
            raise ValueError(f"batch size {bs} is smaller than the data axis ({dp})")
        if bs % dp != 0:  # the per-step loop; the global batch's remainder is dropped
            for batch in batch_iterator(self.data.train.data, bs // dp, shuffle=True,
                                        seed=self.data.seed + epoch):
                yield self._to_device(batch)
            return
        yield from self._staged_batches(epoch)

    def _staged_rows(self):
        """This rank's rows in their staging order: on the device for the
        resident epoch, on the host for the chunked one (kept per run)."""
        if self._rows is None:
            local = self.data.train.data
            usable = usable_local_rows(self.mesh, len(local))
            rows = local[:usable][staging_perm(self.seed, self.mesh.data_index, usable)]
            self._rows = rows if self.chunk_steps > 0 else stage_dataset(rows, self.device)
        return self._rows

    def _staged_batches(self, epoch: int) -> Iterator[torch.Tensor]:
        """Each step's rows: this rank's column of ``host_epoch_perm`` over its
        staged rows, the step count from global counts."""
        rows, dp = self._staged_rows(), self.mesh.dp
        local_bs, shard_len = self.data.batch_size // dp, len(rows)
        n = (shard_len * dp) // self.data.batch_size
        if self.chunk_steps <= 0:  # resident: gather each batch on the device
            idx = epoch_perm(self.mesh, self.seed, epoch, n, local_bs, shard_len,
                             device=self.device).long()
            for s in range(n):
                yield rows[idx[s]]
            return
        perm = host_epoch_perm(self.seed, epoch, n, local_bs, shard_len, dp)
        perm = perm[:, self.mesh.data_index]
        spans = [(c, min(c + self.chunk_steps, n)) for c in range(0, n, self.chunk_steps)]

        def stage(c0, c1):  # the chunk's rows gathered on the host, then moved
            return self._to_device(rows[perm[c0:c1]])

        nxt = stage(*spans[0]) if spans else None
        for i in range(len(spans)):
            cur, nxt = nxt, (stage(*spans[i + 1]) if i + 1 < len(spans) else None)
            yield from cur

    # -- preemption -------------------------------------------------------------

    def _install_preemption_handler(self):
        """SIGTERM -> stop at the next epoch boundary.  Only on the main
        thread (signal handlers are main-thread-only) and with
        ``handle_preemption``; returns the handler to put back, or None."""
        if not self.handle_preemption or threading.current_thread() is not threading.main_thread():
            return None

        def on_term(signum, frame):
            self._preempted = True

        try:
            prev = signal.signal(signal.SIGTERM, on_term)
        except ValueError:
            return None
        return signal.SIG_DFL if prev is None else prev  # None: not set from Python

    @staticmethod
    def _restore_preemption_handler(prev) -> None:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)

    def _stop_requested(self) -> bool:
        """This rank's stop request, or in a world any rank's (so every rank
        leaves at the same epoch boundary)."""
        if self.stop_flag is not None and self.stop_flag():
            self._preempted = True
        if self.mesh is not None:
            flag = torch.tensor([float(self._preempted)], device=self.device)
            self._preempted = bool(all_reduce(flag, dist.group.WORLD, op="max").item())
        return self._preempted

    # -- loop -------------------------------------------------------------------

    def fit(self, max_epochs: Optional[int] = None, max_steps: Optional[int] = None,
            resume: bool = False) -> Dict[str, Any]:
        """Train epochs ``[start, max_epochs)`` (the config's ``max_epochs``
        by default), stopping early after ``max_steps`` steps of this call,
        when validation stops improving, or at a stop request.

        ``resume=True`` with a ``last`` slot in the run directory restores
        the weights, Adam's moments and step counts and the learning rate,
        and continues at the slot's epoch + 1 with its global step count and
        best validation loss; the plateau and early-stopping state start
        afresh, as in JAX.  The noise generator is reseeded from ``seed`` at
        the start of every ``fit``, on resume too: JAX restarts its key
        stream from ``PRNGKey(seed)`` (``rlvae_tpu/train/trainer.py:506``),
        so a resumed run does not draw the noise an uninterrupted run would
        have, and the generator's state is not saved.
        """
        max_epochs = self.max_epochs if max_epochs is None else int(max_epochs)
        self.generator.manual_seed(self._noise_seed())
        best_val, step, start_epoch = math.inf, 0, 0
        if resume and self.checkpoints.exists("last"):
            restored = self.checkpoints.restore("last", map_location=self.device)
            self._load_params(restored["params"])
            self._load_adam_state(restored["optimizer"])
            best_val = float(restored["val_loss"])
            step = int(restored["step"])
            start_epoch = int(restored["epoch"]) + 1
        first_step = step
        epoch = start_epoch - 1
        t_start = time.perf_counter()
        timer = StepTimer()
        prev_handler = self._install_preemption_handler()
        try:
            self.callbacks.on_train_begin(self.cfg, trainer=self)
            for epoch in range(start_epoch, max_epochs):
                if self._stop_requested():
                    self.logger.log({"preempted_at": epoch}, step=step)
                    epoch -= 1  # this epoch did not run
                    break
                t_epoch = time.perf_counter()
                self.callbacks.on_epoch_begin(self.cfg, epoch=epoch, trainer=self)
                last: Optional[Metrics] = None
                with trace(self.run_dir / "profile",
                           enabled=self.profile and epoch == 0 and self.is_main):
                    for x in self._train_batches(epoch):
                        if max_steps is not None and step - first_step >= max_steps:
                            break
                        self.callbacks.call_event("on_train_step_begin", self.cfg, step=step)
                        noise = self.model.draw_posterior_noise(x.shape[0], self.generator)
                        timer.start()
                        last = self.train_step(x, noise)
                        if (step + 1) % self.log_every == 0:
                            self._sync()  # the logged step is timed to its end on the card
                        timer.stop()
                        step += 1
                        if step % self.log_every == 0:
                            host = {f"train/{k}": float(v) for k, v in last.items()}
                            host["lr"] = get_lr(self.optimizer)
                            host.update(timer.metrics())
                            self.logger.log(host, step=step)
                            self.callbacks.on_train_step_end(self.cfg, step=step, logs=host)
                            self.callbacks.on_log(self.cfg, host, step=step)

                val = self.evaluate("val", epoch, weights="live")
                val_loss = val.get("loss", float("nan"))
                lr = get_lr(self.optimizer)
                new_lr = self.scheduler.step(val_loss, lr)
                if new_lr != lr:
                    set_lr(self.optimizer, new_lr)
                summary = {"epoch": epoch, "epoch_time": time.perf_counter() - t_epoch,
                           **{f"val/{k}": v for k, v in val.items()}}
                if last is not None:
                    summary.update({f"train/{k}": float(v) for k, v in last.items()})
                self.logger.log(summary, step=step)
                self.history.append(summary)
                self.callbacks.on_evaluate(self.cfg, epoch=epoch, metrics=val)
                self.callbacks.on_epoch_end(self.cfg, epoch=epoch, logs=summary, trainer=self)
                if val_loss < best_val:
                    best_val = val_loss
                    self.checkpoints.save("best", {"params": self._params(), "step": step,
                                                   "val_loss": val_loss})
                    self._barrier()
                    self.callbacks.on_save(self.cfg, slot="best", step=step)
                if self.viz_hook is not None:
                    self.viz_hook(epoch=epoch, model=self.model,
                                  variables=self.model.state_dict(), trainer=self)
                stop = self.early_stopping.update(val_loss)
                if stop:
                    self.logger.log({"early_stopped_at": epoch}, step=step)
                if self._stop_requested():
                    self.logger.log({"preempted_at": epoch}, step=step)
                    stop = True
                if stop or (max_steps is not None and step - first_step >= max_steps):
                    break
        finally:
            # an exception in fit must not leave this trainer's handler installed
            self._restore_preemption_handler(prev_handler)

        self.checkpoints.save("last", {"params": self._params(),
                                       "optimizer": self._adam_state(),
                                       "step": step, "epoch": epoch, "val_loss": best_val})
        self._barrier()
        result = {"best_val_loss": best_val, "epochs_run": epoch + 1, "steps": step,
                  "train_time": time.perf_counter() - t_start, "preempted": self._preempted,
                  "history": self.history}
        self.logger.summary({k: v for k, v in result.items() if k != "history"})
        self.callbacks.on_save(self.cfg, slot="last", step=step)
        self.callbacks.on_train_end(self.cfg, result=dict(result))
        return result

    def evaluate(self, split: str = "test", epoch: int = 0,
                 weights: str = "best") -> Dict[str, float]:
        """Batch-size-weighted means of the evaluation metrics over a split.

        ``split`` defaults to ``"test"``, as JAX's ``evaluate``.  ``weights``
        says which weights: ``"best"``, the default, evaluates the ``best``
        slot of the run directory (as JAX restores it when no variables are
        given) and leaves the live weights as they were; ``"live"`` evaluates
        the model as it stands.  Raises ``FileNotFoundError`` when there is
        no ``best`` slot.  Fires ``on_eval_step_begin``/``_end`` per batch."""
        if weights == "live":
            return self._evaluate(split, epoch)
        if weights != "best":
            raise ValueError(f"weights must be 'best' or 'live', got {weights!r}")
        best = self.checkpoints.restore("best", map_location=self.device)["params"]
        live = self._params()
        self._load_params(best)
        try:
            return self._evaluate(split, epoch)
        finally:
            self._load_params(live)

    def _evaluate(self, split: str, epoch: int) -> Dict[str, float]:
        batches = self.data.val_batches() if split == "val" else self.data.test_batches()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1 + epoch)
        acc: Dict[str, List[float]] = {}
        sizes: List[int] = []
        for i, batch in enumerate(batches):
            self.callbacks.call_event("on_eval_step_begin", self.cfg, step=i)
            x = self._to_device(batch)
            noise = self.model.draw_posterior_noise(x.shape[0], gen)
            host = self._eval_batch(x, noise)
            sizes.append(x.shape[0])
            for k, v in host.items():
                acc.setdefault(k, []).append(v)
            self.callbacks.call_event("on_eval_step_end", self.cfg, step=i, logs=host)
        return {k: float(np.average(v, weights=sizes)) for k, v in acc.items()}

    def _eval_batch(self, x: torch.Tensor, noise: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        """One batch's metrics; over a data axis of more than one rank (and
        at least one row per rank) each rank evaluates its contiguous rows
        and the row-weighted sums are all-reduced over the data group."""
        dp = 1 if self.mesh is None else self.mesh.dp
        n = x.shape[0]
        if dp == 1 or n < dp:
            return {k: float(v) for k, v in self.eval_step(x, noise).items()}
        bounds = np.linspace(0, n, dp + 1).round().astype(int)
        lo, hi = bounds[self.mesh.data_index], bounds[self.mesh.data_index + 1]
        metrics = self.eval_step(x[lo:hi], {k: v[lo:hi] for k, v in noise.items()})
        sums = torch.stack([v.float() * (hi - lo) for v in metrics.values()]
                           + [torch.tensor(float(hi - lo), device=x.device)])
        sums = all_reduce(sums, self.mesh.data_group).tolist()
        return {k: v / sums[-1] for k, v in zip(metrics, sums)}
