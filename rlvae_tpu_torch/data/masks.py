"""Missing-data masks for the longitudinal research models.

Port of ``rlvae_tpu/data/masks.py`` (host-side numpy, so from the same seed
the masks are JAX's bit for bit): per-batch shared sequence masks that keep
at least 2 observed frames per sequence (:func:`make_batched_masks`),
Bernoulli pixel masks (:func:`make_pixel_masks`), the six masks of one
(p_data, p_pixels) setting saved as one ``.npz``
(:func:`create_and_save_masks`) and read back (:func:`load_masks`).  The
research models take them as [B, T] and [B, T, C, H, W] float tensors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np


def make_batched_masks(data_shape: Sequence[int], prob_missing_data: float, batch_size: int,
                       seed: int = 0) -> np.ndarray:
    """[N, T] sequence masks: every batch shares one pattern, and every
    sequence keeps >= 2 observed frames.  The keep probability of the other
    T - 2 frames is corrected for the 2 forced ones, so the expected missing
    fraction is ``prob_missing_data``: p = ((1 - p_miss) - 2/T) * T / (T - 2)."""
    n, t = int(data_shape[0]), int(data_shape[1])
    if t <= 2:
        return np.ones((n, t), np.float32)
    rng = np.random.default_rng(seed)
    prob = np.clip(((1.0 - prob_missing_data) - 2.0 / t) * t / (t - 2.0), 0.0, 1.0)
    mask = np.ones((n, t), np.float32)
    for i in range(-(-n // batch_size)):
        pattern = np.ones(t, np.float32)
        pattern[2:] = (rng.random(t - 2) < prob).astype(np.float32)
        pattern = pattern[rng.permutation(t)]  # which frames survive
        mask[i * batch_size:min((i + 1) * batch_size, n)] = pattern[None, :]
    return mask


def make_pixel_masks(data_shape: Sequence[int], prob_missing_pixels: float,
                     seed: int = 0) -> np.ndarray:
    """[N, T, C, H, W] independent Bernoulli pixel masks (1: observed)."""
    rng = np.random.default_rng(seed)
    if prob_missing_pixels <= 0.0:
        return np.ones(tuple(data_shape), np.float32)
    return (rng.random(tuple(data_shape)) >= prob_missing_pixels).astype(np.float32)


def create_and_save_masks(out_dir: str | Path, train_shape: Sequence[int],
                          eval_shape: Sequence[int], test_shape: Sequence[int],
                          prob_missing_data: float = 0.0, prob_missing_pixels: float = 0.0,
                          batch_size: int = 128, seed: int = 0) -> Path:
    """The sequence and pixel masks of the train, eval and test splits (seeds
    ``seed`` ... ``seed + 5``) in one compressed ``.npz`` under ``out_dir``,
    named by the two probabilities; returns its path."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"mask_miss_data_{prob_missing_data}_miss_pixels_{prob_missing_pixels}.npz"
    np.savez_compressed(
        path,
        train_seq_mask=make_batched_masks(train_shape, prob_missing_data, batch_size, seed),
        eval_seq_mask=make_batched_masks(eval_shape, prob_missing_data, batch_size, seed + 1),
        test_seq_mask=make_batched_masks(test_shape, prob_missing_data, batch_size, seed + 2),
        train_pix_mask=make_pixel_masks(train_shape, prob_missing_pixels, seed + 3),
        eval_pix_mask=make_pixel_masks(eval_shape, prob_missing_pixels, seed + 4),
        test_pix_mask=make_pixel_masks(test_shape, prob_missing_pixels, seed + 5),
    )
    return path


def load_masks(path: str | Path) -> dict:
    """The masks of a :func:`create_and_save_masks` file, as fp32 arrays."""
    with np.load(path) as zf:
        return {k: zf[k].astype(np.float32) for k in zf.files}
