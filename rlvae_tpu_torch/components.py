"""Train a vanilla VAE on sequence frames and export the pretrained components.

    python -m rlvae_tpu_torch.components --out-dir runs/components [--dataset PATH]
        [--epochs 50] [--metric-epochs 10] [--latent-dim 16] [--synthetic N]

The port's counterpart of ``scripts/train_and_extract_components.py``, with
the same flags.  In order it trains the vanilla VAE (MLP encoder and
decoder, Adam at 1e-3, each epoch on ``default_rng(epoch)``'s permutation);
writes ``encoder.npz`` and ``decoder.npz`` in the flat ``params/...``
format both packages load; trains the RHVAE warm-started from that VAE
(:func:`rlvae_tpu_torch.geometry.pretrain.train_metric`); caps the
consolidated metric at ``--metric-centroids`` with
``default_rng(seed).choice``; and saves ``metric.npz``
(:func:`rlvae_tpu_torch.geometry.save_metric`).  Everything is written to
``--out-dir`` (required: the shipped ``data/pretrained/`` is not
overwritten).  Runs on the CUDA card unless ``--device`` names another
device, and fails without one.  Prints one JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from rlvae_tpu_torch.convert import save_component_npz
from rlvae_tpu_torch.data import generate_cyclic_sequences
from rlvae_tpu_torch.data.cyclic import _load_array
from rlvae_tpu_torch.device import resolve_device
from rlvae_tpu_torch.geometry.loader import save_metric
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.geometry.pretrain import RHVAE, train_metric
from rlvae_tpu_torch.nets import MLPDecoder, MLPEncoder
from rlvae_tpu_torch.train.optim import make_optimizer


def train_vae(frames: np.ndarray, latent_dim: int, epochs: int, batch_size: int,
              device: torch.device, generator: torch.Generator):
    """(encoder, decoder) of a vanilla VAE trained on frames [N, C, H, W]:
    loss mean(sum (recon - x)^2) + mean KL(q || N(0, I))."""
    input_dim = tuple(frames.shape[1:])
    encoder = MLPEncoder(input_dim, latent_dim).to(device)
    decoder = MLPDecoder(input_dim, latent_dim).to(device)
    optimizer = make_optimizer([*encoder.parameters(), *decoder.parameters()], 1e-3)
    n = (frames.shape[0] // batch_size) * batch_size
    for epoch in range(epochs):
        perm = np.random.default_rng(epoch).permutation(frames.shape[0])[:n]
        losses = []
        for b in range(n // batch_size):
            batch = torch.from_numpy(frames[perm[b * batch_size:(b + 1) * batch_size]]).to(device)
            enc = encoder(batch)
            mu, log_var = enc["embedding"], enc["log_covariance"]
            eps = torch.randn(mu.shape, generator=generator, device=device)
            recon = decoder(mu + eps * torch.exp(0.5 * log_var))["reconstruction"]
            recon_l = ((recon - batch) ** 2).reshape(batch.shape[0], -1).sum(-1).mean()
            kl = (-0.5 * (1 + log_var - mu ** 2 - torch.exp(log_var)).sum(-1)).mean()
            loss = recon_l + kl
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        if epoch % 10 == 0 or epoch == epochs - 1:
            print(f"[vae] epoch {epoch}: loss {float(torch.stack(losses).mean()):.3f}")
    return encoder, decoder


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m rlvae_tpu_torch.components", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", type=Path, default=None,
                    help="[N,T,C,H,W] dataset (.npz/.npy); synthetic if omitted")
    ap.add_argument("--synthetic", type=int, default=200)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--metric-epochs", type=int, default=10)
    ap.add_argument("--latent-dim", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=42,
                    help="synthetic-data seed; 42 matches CyclicDataModule's default")
    ap.add_argument("--metric-centroids", type=int, default=200,
                    help="cap the consolidated metric at this many centroids")
    ap.add_argument("--out-dir", type=Path, required=True)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.dataset is not None:
        seqs = _load_array(args.dataset)
    else:
        seqs = generate_cyclic_sequences(args.synthetic, n_obs=8,
                                         image_size=(args.image_size, args.image_size),
                                         seed=args.seed)
    frames = np.ascontiguousarray(seqs.reshape(-1, *seqs.shape[2:]), np.float32)
    input_dim = tuple(frames.shape[1:])
    print(f"training on {frames.shape[0]} frames, input_dim={input_dim}")

    generator = torch.Generator(device=device).manual_seed(42)
    encoder, decoder = train_vae(frames, args.latent_dim, args.epochs, args.batch_size, device,
                                 generator)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    save_component_npz(encoder, args.out_dir / "encoder.npz")
    save_component_npz(decoder, args.out_dir / "decoder.npz")
    print(f"wrote {args.out_dir}/encoder.npz, decoder.npz")

    # the metric via the RHVAE, warm-started from the VAE so the learned
    # centroids live where the pretrained encoder puts latents
    rhvae = RHVAE(input_dim=input_dim, latent_dim=args.latent_dim).to(device)
    metric, info = train_metric(
        rhvae, frames, n_epochs=args.metric_epochs, batch_size=args.batch_size, log_every=2,
        warm_start={"encoder": encoder.state_dict(), "decoder": decoder.state_dict()},
    )
    if metric.n_centroids > args.metric_centroids:
        sel = np.random.default_rng(args.seed).choice(
            metric.n_centroids, args.metric_centroids, replace=False)
        metric = CentroidMetric.create(metric.centroids.numpy()[sel], metric.matrices.numpy()[sel],
                                       metric.temperature, metric.regularization)
    save_metric(metric, args.out_dir / "metric.npz")
    print(f"wrote {args.out_dir}/metric.npz ({metric.n_centroids} centroids)")
    summary = {"out_dir": str(args.out_dir), "frames": int(frames.shape[0]),
               "n_centroids": metric.n_centroids, "loss_history": info["loss_history"],
               "device": str(device)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
