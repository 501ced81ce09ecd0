"""Train ``riemannian_flow_vae`` on synthetic cyclic sprites.

    python -m rlvae_tpu_torch.train --steps 20 --batch-size 16

Runs on the CUDA card unless ``--device`` names another device, and fails
without one.  The model is ``PRESETS["riemannian_flow_vae"]`` (pretrained
encoder and decoder, seeded flows); the training settings are a training
preset (``default`` unless ``--preset`` says otherwise).  Prints one JSON
line per epoch and a summary line.
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import Optional, Sequence

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
    p.add_argument("--preset", default="default", choices=sorted(TRAINING_PRESETS))
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # fails at once without the card
    cfg = copy.deepcopy(TRAINING_PRESETS[args.preset])
    if args.batch_size is not None:
        cfg["data"]["batch_size"] = args.batch_size
    if args.steps is not None:  # synthesize no more training sequences than the run uses
        cfg["n_train_samples"] = args.steps * cfg["data"]["batch_size"]
    data = CyclicDataModule(seed=args.seed)
    data.setup(cfg)
    model = create_model(PRESETS["riemannian_flow_vae"], seed=args.seed)
    trainer = Trainer(model, data, cfg, seed=args.seed, device=device)
    result = trainer.fit(max_steps=args.steps)
    for summary in result["history"]:
        print(json.dumps(summary), flush=True)
    summary = {k: v for k, v in result.items() if k != "history"}
    print(json.dumps({"device": str(device), **summary}), flush=True)
    return result


if __name__ == "__main__":
    main()
