"""Synthetic cyclic sequences: the port's own copy of
``rlvae_tpu/data/synth.py`` (:func:`generate_cyclic_sequences`, and
:func:`write_synthetic_dataset`, which saves them as a dataset ``.npz``).

The Sprites data is not redistributable, so every config can train on
deterministic synthetic sequences with the same tensor contract:
[N, T, C, H, W] float32 in [0, 1], first frame == last frame.  Each sequence
is a coloured sprite (ellipse, rectangle or cross) orbiting a closed path
with per-sequence radius, phase, colours and shape; the angle sweeps
2*pi*t/(T-1), so frames 0 and T-1 coincide exactly.  Same seed, same
numpy draws, same arrays as the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np


def _draw_sprite(h, w, cx, cy, size, color, shape, angle):
    """Render one sprite frame [C, H, W] with soft edges."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dx, dy = xx - cx, yy - cy
    ca, sa = np.cos(angle), np.sin(angle)
    rx = ca * dx + sa * dy
    ry = -sa * dx + ca * dy
    if shape == 0:  # ellipse
        d = (rx / size) ** 2 + (ry / (0.6 * size)) ** 2
        mask = np.clip(1.5 - d, 0.0, 1.0)
    elif shape == 1:  # rectangle
        d = np.maximum(np.abs(rx) / size, np.abs(ry) / (0.7 * size))
        mask = np.clip((1.2 - d) * 4.0, 0.0, 1.0)
    else:  # cross
        d = np.minimum(
            np.maximum(np.abs(rx) / size, np.abs(ry) / (0.3 * size)),
            np.maximum(np.abs(rx) / (0.3 * size), np.abs(ry) / size),
        )
        mask = np.clip((1.1 - d) * 4.0, 0.0, 1.0)
    frame = color[:, None, None] * mask[None, :, :]
    return np.clip(frame, 0.0, 1.0)


def generate_cyclic_sequences(
    n_sequences: int,
    n_obs: int = 8,
    image_size: Tuple[int, int] = (64, 64),
    channels: int = 3,
    seed: int = 0,
) -> np.ndarray:
    """[N, T, C, H, W] float32 cyclic sequences (frame 0 == frame T-1)."""
    h, w = image_size
    rng = np.random.default_rng(seed)
    data = np.zeros((n_sequences, n_obs, channels, h, w), np.float32)
    for n in range(n_sequences):
        color = rng.uniform(0.3, 1.0, size=channels).astype(np.float32)
        shape = int(rng.integers(0, 3))
        radius = rng.uniform(0.15, 0.3) * min(h, w)
        phase = rng.uniform(0.0, 2 * np.pi)
        size = rng.uniform(0.1, 0.2) * min(h, w)
        spin = rng.choice([-1.0, 0.0, 1.0])
        cx0, cy0 = w / 2.0, h / 2.0
        for t in range(n_obs):
            theta = 2 * np.pi * t / (n_obs - 1) + phase
            cx = cx0 + radius * np.cos(theta)
            cy = cy0 + radius * np.sin(theta)
            data[n, t] = _draw_sprite(h, w, cx, cy, size, color, shape, spin * theta)
        data[n, -1] = data[n, 0]  # exact cyclicity
    return data


def write_synthetic_dataset(path, n_sequences, n_obs=8, image_size=(64, 64), channels=3, seed=0):
    """Write a dataset ``.npz`` under the key ``sequences``; returns its shape."""
    data = generate_cyclic_sequences(n_sequences, n_obs, image_size, channels, seed)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, sequences=data)
    return data.shape
