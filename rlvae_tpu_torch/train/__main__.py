"""Train a model preset on synthetic cyclic sprites.

    python -m rlvae_tpu_torch.train --steps 20 --batch-size 16 --run-dir runs/a
    python -m rlvae_tpu_torch.train --steps 20 --batch-size 16 --run-dir runs/a --resume
    python -m rlvae_tpu_torch.train --model riemannian_flow_vae_fast --steps 20
    python -m rlvae_tpu_torch.train --world 2 --steps 20 --batch-size 16 --run-dir runs/dp
    python -m rlvae_tpu_torch.train --world 4 --model-parallel 2 --device cpu --steps 2

Runs on the CUDA card unless ``--device`` names another device, and fails
without one.  The model is ``PRESETS[--model]`` (``riemannian_flow_vae``
unless ``--model`` says otherwise; the counterpart of the JAX package's
``model=`` override), with pretrained encoder and decoder and seeded flows;
the training settings are a training preset (``default`` unless
``--preset`` says otherwise).  The run directory (``--run-dir``,
``outputs/run`` by default as in JAX) receives ``config.yaml``, the
checkpoint slots ``checkpoints/{best,last}``, ``metrics.jsonl`` and
``summary.json``; ``config.yaml`` holds ``{"model", "training", "seed"}``
(YAML, written by :func:`rlvae_tpu_torch.config.save_config`), and
``ModelManager.from_run(run_dir)`` loads the trained model from it.  The
Hydra-style runs over ``conf/`` are ``python -m
rlvae_tpu_torch.experiment``.
``--resume`` continues from ``checkpoints/last`` (``Trainer.fit``);
``--steps`` counts the steps of this invocation.  Prints one JSON line per
epoch and a summary line.

``--world N`` trains data-parallel (x ``--model-parallel M`` tensor-parallel)
over N ranks: the command starts N processes of itself on this machine
(:mod:`rlvae_tpu_torch.parallel.launch`; rank r on ``cuda:(r % cards)``),
joined through a ``file://`` store in the run directory, NCCL on the card
unless ``--backend gloo`` (NCCL refuses two ranks on one card), gloo on the
CPU.  The training config's ``trainer.devices`` becomes N / M and
``trainer.model_parallel`` M; ``--batch-size`` stays the global batch.
Rank 0 writes the run directory and prints; each rank's output is in
``RUN_DIR/rank{r}.log``.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from rlvae_tpu_torch.config import Config, save_config
from rlvae_tpu_torch.data import CyclicDataModule
from rlvae_tpu_torch.device import is_main_process, resolve_device
from rlvae_tpu_torch.parallel.launch import (
    check_backend,
    default_backend,
    init_world,
    rank_logs,
    spawn_ranks,
)
from rlvae_tpu_torch.models import PRESETS, create_model
from rlvae_tpu_torch.train.presets import TRAINING_PRESETS
from rlvae_tpu_torch.train.trainer import Trainer


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m rlvae_tpu_torch.train", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=None,
                   help="stop after this many train steps (default: the preset's epochs)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="sequences per step (default: the preset's)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--model", default="riemannian_flow_vae", choices=sorted(PRESETS))
    p.add_argument("--preset", default="default", choices=sorted(TRAINING_PRESETS))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--run-dir", default="outputs/run",
                   help="checkpoints, metrics and config.yaml (default: outputs/run)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the run directory's 'last' checkpoint")
    p.add_argument("--world", type=int, default=None,
                   help="train over this many processes (one device each)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks per model group of the --world (tensor parallelism)")
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="the world's backend: nccl on the card, gloo on the CPU by default")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="seconds for the whole --world run")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # fails at once without the card
    run_dir = Path(args.run_dir)
    if args.world is not None:
        kind = "cpu" if device.type == "cpu" else "cuda"
        backend = args.backend or default_backend(kind)
        if args.world < 1 or args.model_parallel < 1 or args.world % args.model_parallel:
            raise SystemExit(f"--world {args.world} must be a multiple of --model-parallel "
                             f"{args.model_parallel}")
        if args.rank is None:  # the launcher: start the ranks and wait for them
            check_backend(backend, args.world, kind)
            rank_argv = [*(sys.argv[1:] if argv is None else argv),
                         "--run-dir", str(run_dir.resolve())]
            failed = spawn_ranks("rlvae_tpu_torch.train", rank_argv, args.world, run_dir,
                                 args.timeout)
            (run_dir / "store").unlink(missing_ok=True)
            if failed:
                print(rank_logs(run_dir, args.world), file=sys.stderr)
                raise SystemExit(f"the --world run failed: {failed}")
            print((run_dir / "rank0.log").read_text(), end="", flush=True)
            return {}
        device = init_world(backend, args.world, args.rank, run_dir, kind)
    cfg = copy.deepcopy(TRAINING_PRESETS[args.preset])
    if args.world is not None:
        cfg["trainer"]["devices"] = args.world // args.model_parallel
        cfg["trainer"]["model_parallel"] = args.model_parallel
    if args.batch_size is not None:
        cfg["data"]["batch_size"] = args.batch_size
    if args.steps is not None:  # synthesize no more training sequences than the run uses
        cfg["n_train_samples"] = args.steps * cfg["data"]["batch_size"]
    run_dir.mkdir(parents=True, exist_ok=True)
    model_cfg = PRESETS[args.model]
    if is_main_process():
        save_config(Config({"model": model_cfg, "training": cfg, "seed": args.seed}),
                    run_dir / "config.yaml")
    data = CyclicDataModule(seed=args.seed)
    data.setup(cfg)
    model = create_model(model_cfg, seed=args.seed)
    trainer = Trainer(model, data, cfg, run_dir=run_dir, seed=args.seed, device=device)
    result = trainer.fit(max_steps=args.steps, resume=args.resume)
    if args.world is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    if is_main_process():
        for summary in result["history"]:
            print(json.dumps(summary), flush=True)
        summary = {k: v for k, v in result.items() if k != "history"}
        print(json.dumps({"device": str(device), "run_dir": str(run_dir), "world": args.world,
                          **summary}), flush=True)
    return result


if __name__ == "__main__":
    main()
