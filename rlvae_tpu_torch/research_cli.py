"""The research models' experiment CLI: the legacy pythae script surface.

    python -m rlvae_tpu_torch.research_cli --model lvae_iaf --num_epochs 2 --batch_size 8
    python -m rlvae_tpu_torch.research_cli --model vamp --compute_nll 1
    python -m rlvae_tpu_torch.research_cli --make_masks --prob_missing_data 0.3
    python -m rlvae_tpu_torch.research_cli --model gpvae --device cpu --n_train 8 --n_eval 4
    python -m rlvae_tpu_torch.research_cli --model lldm --posterior iaf --num_epochs 2

Port of ``scripts/research_cli.py`` with the same arguments, plus ``--device``
(``cuda`` by default, which raises without a card; ``cpu`` for the tests):
one CLI over the port's research zoo (``LVAE_IAF``, ``VAMP``, ``GPVAE``,
``RIEM``, ``LLDM``, ``LVAE_GUGUS``), with the dataset table (a
``--data_path`` file, ``.npz``, ``.npy`` or ``.pt``, or synthetic cyclic
sequences of the dataset's frame shape), the prior and posterior switches,
missing-data and missing-pixel masks made on the host and staged per batch,
KL warmup and linear beta scheduling, and the MSE and NLL evaluation (the
NLL of the models with ``estimate_nll``: not LLDM's, as in JAX).
``--make_masks`` only writes the masks' ``.npz`` (the reference's mask
script).

Training is a plain ``torch.optim.Adam`` loop over the model's forward:
per epoch a seeded permutation of the training sequences, per step the
visit drawn from its own seeded generator once the warmup is over (the
epoch passed to the model saturates at max(warmup, linear scheduling), as
JAX's does to stop retracing).  The model's draws come from one
``torch.Generator`` seeded ``--seed``, so the losses are not JAX's.  Writes
``results.json`` (the history and the result) and ``params.npz`` (the
state dict) under ``--output_dir/<model>_<dataset>`` and prints the result
as one JSON line (``model``, ``dataset``, ``epochs``, ``final_loss``,
``train_time_s``, ``eval_mse``, ``eval_nll`` when asked).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

MODELS = ("lvae_iaf", "vamp", "gpvae", "riem", "lldm", "gugus")
DATASETS = ("synthetic", "sprites", "starmen", "colormnist", "rotated_mnist", "faces")
DATASET_DIMS = {
    "synthetic": (3, 32, 32),
    "sprites": (3, 64, 64),
    "starmen": (1, 64, 64),
    "colormnist": (3, 28, 28),
    "rotated_mnist": (1, 28, 28),
    "faces": (3, 64, 64),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=MODELS, default="lvae_iaf")
    ap.add_argument("--dataset", choices=DATASETS, default="synthetic")
    ap.add_argument("--data_path", type=str, default=None,
                    help=".npz/.npy/.pt sequence file overriding the dataset table")
    ap.add_argument("--latent_dim", type=int, default=16)
    ap.add_argument("--n_obs", type=int, default=8)
    ap.add_argument("--prior", choices=["standard", "vamp"], default="standard")
    ap.add_argument("--posterior", choices=["gaussian", "iaf"], default="gaussian")
    ap.add_argument("--prob_missing_data", type=float, default=0.0)
    ap.add_argument("--prob_missing_pixels", type=float, default=0.0)
    ap.add_argument("--n_hidden_in_made", type=int, default=3)
    ap.add_argument("--n_made_blocks", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--vamp_number_components", type=int, default=50)
    ap.add_argument("--linear_scheduling_steps", type=int, default=0)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--num_epochs", type=int, default=10)
    ap.add_argument("--learning_rate", type=float, default=1e-3)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--n_train", type=int, default=64)
    ap.add_argument("--n_eval", type=int, default=16)
    ap.add_argument("--compute_nll", type=int, default=0)
    ap.add_argument("--compute_mse", type=int, default=1)
    ap.add_argument("--nll_n_samples", type=int, default=50)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--output_dir", type=str, default="outputs/research")
    ap.add_argument("--make_masks", action="store_true",
                    help="only generate and save the masks' .npz (mask_creation_script.py)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda (the default; raises without a card) or cpu")
    return ap


def load_data(args):
    """(train, eval) [N, T, C, H, W] float32: the file's first n_train +
    n_eval sequences, or synthetic cyclic sequences of the dataset's shape."""
    if args.data_path:
        from rlvae_tpu_torch.data.cyclic import _load_array

        data = _load_array(Path(args.data_path))
    else:
        from rlvae_tpu_torch.data.synth import generate_cyclic_sequences

        c, h, w = DATASET_DIMS[args.dataset]
        data = generate_cyclic_sequences(args.n_train + args.n_eval, n_obs=args.n_obs,
                                         image_size=(h, w), channels=c, seed=args.seed)
    train = data[: args.n_train]
    eval_ = data[args.n_train: args.n_train + args.n_eval]
    return np.asarray(train, np.float32), np.asarray(eval_, np.float32)


def build_model(args, input_dim):
    from rlvae_tpu_torch.models.research import GPVAE, LLDM, LVAE_GUGUS, LVAE_IAF, RIEM, VAMP

    common = dict(input_dim=input_dim, latent_dim=args.latent_dim)
    if args.model == "lvae_iaf":
        return LVAE_IAF(
            n_obs=args.n_obs, warmup=args.warmup, beta=args.beta,
            linear_scheduling_steps=args.linear_scheduling_steps,
            n_made_blocks=args.n_made_blocks, n_hidden_in_made=args.n_hidden_in_made,
            prior=args.prior, posterior=args.posterior,
            vamp_number_components=args.vamp_number_components, **common)
    if args.model == "vamp":
        return VAMP(number_components=args.vamp_number_components,
                    linear_scheduling_steps=args.linear_scheduling_steps, **common)
    if args.model == "gpvae":
        return GPVAE(time_length=args.n_obs, beta=args.beta, **common)
    if args.model == "riem":
        return RIEM(n_obs=args.n_obs, warmup=args.warmup, beta=args.beta, prior=args.prior,
                    posterior=args.posterior, **common)
    if args.model == "lldm":
        return LLDM(n_obs=args.n_obs, warmup=args.warmup, beta=args.beta, prior=args.prior,
                    posterior=args.posterior, **common)
    if args.model == "gugus":
        return LVAE_GUGUS(n_obs=args.n_obs, warmup=args.warmup, beta=args.beta,
                          prior=args.prior, posterior=args.posterior, **common)
    raise ValueError(args.model)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    out_dir = Path(args.output_dir) / f"{args.model}_{args.dataset}"

    from rlvae_tpu_torch.data.masks import (
        create_and_save_masks,
        make_batched_masks,
        make_pixel_masks,
    )

    train, eval_ = load_data(args)
    if args.make_masks:
        path = create_and_save_masks(out_dir / "masks", train.shape, eval_.shape, eval_.shape,
                                     args.prob_missing_data, args.prob_missing_pixels,
                                     args.batch_size, args.seed)
        print(json.dumps({"masks": str(path)}))
        return 0

    import torch

    from rlvae_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    model = build_model(args, tuple(train.shape[2:])).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.learning_rate)
    generator = torch.Generator().manual_seed(args.seed)

    seq_mask = make_batched_masks(train.shape, args.prob_missing_data, args.batch_size, args.seed)
    pix_mask = make_pixel_masks(train.shape, args.prob_missing_pixels, args.seed + 1)
    warmup = int(getattr(model, "warmup", 0) or 0)
    saturate = max(warmup, int(getattr(model, "linear_scheduling", 0) or 0))

    n_steps = train.shape[0] // args.batch_size
    n_obs = train.shape[1]
    vi_rng = np.random.default_rng(args.seed + 17)
    history = []
    t0 = time.time()
    model.train()
    for epoch in range(args.num_epochs):
        perm = np.random.default_rng(args.seed + epoch).permutation(train.shape[0])
        losses = []
        for s in range(n_steps):
            idx = perm[s * args.batch_size:(s + 1) * args.batch_size]
            # one visit per step once the warmup is over (VAMP and GPVAE ignore it)
            vi_index = int(vi_rng.integers(0, n_obs)) if epoch >= warmup else 0
            optimizer.zero_grad(set_to_none=True)
            out = model(torch.from_numpy(train[idx]).to(dev), vi_index=vi_index,
                        epoch=min(epoch, saturate), train=True, generator=generator,
                        seq_mask=torch.from_numpy(seq_mask[idx]).to(dev),
                        pix_mask=torch.from_numpy(pix_mask[idx]).to(dev))
            out.loss.backward()
            optimizer.step()
            losses.append(out.loss.detach())
        losses = [float(v) for v in losses]  # one host read per epoch
        history.append({"epoch": epoch, "loss": float(np.mean(losses))})
        print(f"[{args.model}] epoch {epoch}: loss={np.mean(losses):.4f}", file=sys.stderr)

    model.eval()
    result = {"model": args.model, "dataset": args.dataset, "epochs": args.num_epochs,
              "final_loss": history[-1]["loss"] if history else None,
              "train_time_s": round(time.time() - t0, 2)}
    x_eval = torch.from_numpy(eval_).to(dev)
    with torch.no_grad():
        if args.compute_mse:
            recon = model(x_eval, generator=generator).recon_x.float().cpu().numpy()
            result["eval_mse"] = float(np.mean((recon - eval_) ** 2))
        if args.compute_nll and hasattr(model, "estimate_nll"):
            nll = model.estimate_nll(x_eval[: min(8, len(eval_))], n_samples=args.nll_n_samples,
                                     generator=generator)
            result["eval_nll"] = float(nll.float().mean())

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "results.json").write_text(json.dumps({"history": history, **result}, indent=2))
    np.savez_compressed(out_dir / "params.npz", **{
        name: t.detach().float().cpu().numpy() for name, t in model.state_dict().items()})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
