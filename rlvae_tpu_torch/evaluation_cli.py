"""Model evaluation CLI: reconstruction, missing-data imputation, FID.

Port of ``scripts/evaluation_cli.py``, with ``--device`` (the card by
default): reload a trained run (``ModelManager.from_run``), measure the
reconstruction MSE and the missing-data imputation on held-out sequences,
generate samples, and report a Fréchet distance in pixel and encoder
feature spaces (:mod:`rlvae_tpu_torch.utils.fid`; no Inception weights).
Prints one JSON line.

    python -m rlvae_tpu_torch.evaluation_cli --run_dir outputs/<run> \\
        --n_test 64 --fid_samples 64 --prob_missing_data 0.25
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Model evaluation: reconstruction, missing-data imputation, FID.")
    ap.add_argument("--run_dir", required=True, help="a Trainer run directory")
    ap.add_argument("--slot", default="best", choices=["best", "last"])
    ap.add_argument("--data_path", default=None, help=".npz/.pt test sequences")
    ap.add_argument("--n_test", type=int, default=64)
    ap.add_argument("--n_obs", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--n_runs", type=int, default=3)
    ap.add_argument("--fid_samples", type=int, default=0,
                    help="generate this many samples and report FID (0 = skip)")
    ap.add_argument("--sample_method", default="geodesic")
    ap.add_argument("--prob_missing_data", type=float, default=0.0)
    ap.add_argument("--prob_missing_pixels", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None, help="device to run on (default: the card)")
    args = ap.parse_args(argv)

    from rlvae_tpu_torch.data.masks import make_batched_masks, make_pixel_masks
    from rlvae_tpu_torch.inference import ModelManager
    from rlvae_tpu_torch.utils.evaluation import evaluate_missing, evaluate_reconstruction
    from rlvae_tpu_torch.utils.fid import encoder_features, fid_score, pixel_features

    manager = ModelManager.from_run(args.run_dir, slot=args.slot, device=args.device)
    model = manager.model

    if args.data_path:
        from rlvae_tpu_torch.data.cyclic import _load_array

        data = _load_array(Path(args.data_path))[: args.n_test]
    else:
        from rlvae_tpu_torch.data.synth import generate_cyclic_sequences

        c, h, w = model.input_dim
        data = generate_cyclic_sequences(args.n_test, n_obs=args.n_obs, image_size=(h, w),
                                         channels=c, seed=args.seed + 7)

    result = {"run_dir": args.run_dir, "n_test": int(data.shape[0])}
    result.update(evaluate_reconstruction(model, data, args.seed, batch_size=args.batch_size,
                                          n_runs=args.n_runs))

    if args.prob_missing_data > 0 or args.prob_missing_pixels > 0:
        seq_mask = make_batched_masks(data.shape, args.prob_missing_data, args.batch_size,
                                      args.seed)
        pix_mask = make_pixel_masks(data.shape, args.prob_missing_pixels, args.seed + 1)
        result.update(evaluate_missing(model, data, seq_mask, pix_mask, args.seed + 2,
                                       batch_size=args.batch_size, n_runs=args.n_runs))

    if args.fid_samples > 0:
        gen = manager.sample_random(args.fid_samples, method=args.sample_method, seed=args.seed)
        real = np.asarray(data, np.float32)
        result["fid_pixel"] = fid_score(pixel_features(real), pixel_features(gen))
        enc = lambda x: manager.encode(x).embedding  # noqa: E731
        result["fid_encoder"] = fid_score(encoder_features(enc, real),
                                          encoder_features(enc, gen))

    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in result.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
