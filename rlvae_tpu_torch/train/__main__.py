"""Train a model preset on synthetic cyclic sprites.

    python -m rlvae_tpu_torch.train --steps 20 --batch-size 16 --run-dir runs/a
    python -m rlvae_tpu_torch.train --steps 20 --batch-size 16 --run-dir runs/a --resume
    python -m rlvae_tpu_torch.train --model riemannian_flow_vae_fast --steps 20

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
"""

from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path
from typing import Optional, Sequence

from rlvae_tpu_torch.config import Config, save_config
from rlvae_tpu_torch.data import CyclicDataModule
from rlvae_tpu_torch.device import resolve_device
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
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # fails at once without the card
    cfg = copy.deepcopy(TRAINING_PRESETS[args.preset])
    if args.batch_size is not None:
        cfg["data"]["batch_size"] = args.batch_size
    if args.steps is not None:  # synthesize no more training sequences than the run uses
        cfg["n_train_samples"] = args.steps * cfg["data"]["batch_size"]
    run_dir = Path(args.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    model_cfg = PRESETS[args.model]
    save_config(Config({"model": model_cfg, "training": cfg, "seed": args.seed}),
                run_dir / "config.yaml")
    data = CyclicDataModule(seed=args.seed)
    data.setup(cfg)
    model = create_model(model_cfg, seed=args.seed)
    trainer = Trainer(model, data, cfg, run_dir=run_dir, seed=args.seed, device=device)
    result = trainer.fit(max_steps=args.steps, resume=args.resume)
    for summary in result["history"]:
        print(json.dumps(summary), flush=True)
    summary = {k: v for k, v in result.items() if k != "history"}
    print(json.dumps({"device": str(device), "run_dir": str(run_dir), **summary}), flush=True)
    return result


if __name__ == "__main__":
    main()
