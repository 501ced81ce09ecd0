"""Shared visualization helpers: the port of ``rlvae_tpu/viz/base.py``.

Output paths per epoch, figure saving that never raises, wandb gating, the
PCA used by the plots, the per-epoch forward that every module shares
(:class:`SharedForward`), :func:`to_numpy` and :func:`on_device` for the
fields the plotting modules compute, and :func:`png_b64`, the figure-free
thumbnail renderer of the interactive plots and the app server.
"""

from __future__ import annotations

import base64
import io
import struct
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np


class SharedForward:
    """One model forward per epoch, shared by every visualization module.

    Every module calls ``forward(model, x, seed)`` with the same arguments
    inside one ``visualize_epoch`` (JAX: ``PRNGKey(epoch)``), so the manager
    hands all of them this object and resets it at the start of each epoch:
    the card runs the forward once, not once per module.  The forward runs
    in inference mode on the model's device, its posterior noise drawn from
    a generator there seeded with ``seed``."""

    def __init__(self):
        self._memo = None

    def reset(self) -> None:
        self._memo = None

    def __call__(self, model, x, seed: int):
        import torch

        if self._memo is None:
            dev = next(model.parameters()).device
            xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            with torch.inference_mode():
                self._memo = model(xt, generator=gen)
        return self._memo


def to_numpy(t) -> np.ndarray:
    """A tensor on any device (or an array) as an fp32 numpy array."""
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def on_device(metric, a):
    """``a`` as an fp32 tensor on the device of ``metric``'s bank: the
    plots' grids and paths are evaluated where the metric lives."""
    import torch

    return torch.as_tensor(np.asarray(a, np.float32), device=metric.centroids.device)


class BaseVisualization:
    def __init__(self, config, output_dir: Path, logger=None):
        self.config = config
        self.output_dir = Path(output_dir)
        self.logger = logger
        self._forward = SharedForward()  # replaced by the manager's shared one

    def forward(self, model, x, seed: int):
        """Model forward through the (manager-)shared, memoized path."""
        return self._forward(model, x, seed)

    def _path(self, epoch: int, name: str, ext: str = "png") -> Path:
        d = self.output_dir / f"epoch_{epoch:03d}"
        d.mkdir(parents=True, exist_ok=True)
        return d / f"{name}.{ext}"

    def save_figure(self, fig, epoch: int, name: str) -> Optional[Path]:
        """Save and optionally log a matplotlib figure; never raises."""
        import matplotlib

        matplotlib.use("Agg")
        path = self._path(epoch, name)
        try:
            fig.savefig(path, dpi=100, bbox_inches="tight")
        finally:
            import matplotlib.pyplot as plt

            plt.close(fig)
        if self.logger is not None and getattr(self.config, "log_to_wandb", False):
            self.logger.log_image(f"viz/{name}", path)
        return path

    @staticmethod
    def pca_fit_transform(z: np.ndarray, n_components: int = 2):
        """PCA projection (sklearn when available, numpy SVD otherwise)."""
        z = np.asarray(z, np.float64)
        flat = z.reshape(-1, z.shape[-1])
        try:
            from sklearn.decomposition import PCA

            pca = PCA(n_components=n_components)
            proj = pca.fit_transform(flat)
            return proj.reshape(*z.shape[:-1], n_components), pca
        except ImportError:
            mean = flat.mean(0)
            _, _, vt = np.linalg.svd(flat - mean, full_matrices=False)
            comp = vt[:n_components]
            proj = (flat - mean) @ comp.T
            return proj.reshape(*z.shape[:-1], n_components), (mean, comp)

    def run(self, epoch: int, model, variables, sample_batch) -> List[Path]:
        raise NotImplementedError


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(pixels: np.ndarray) -> bytes:
    """An 8-bit PNG of ``pixels`` [H, W] (grey) or [H, W, 3|4] (RGB[A]),
    uint8, written with the standard library alone."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    channels = 1 if pixels.ndim == 2 else pixels.shape[2]
    color = {1: 0, 3: 2, 4: 6}[channels]
    rows = pixels.reshape(h, w * channels)
    raw = b"".join(b"\x00" + rows[i].tobytes() for i in range(h))  # filter 0 per row
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def png_b64(frame_chw) -> str:
    """[C, H, W] float array -> base64 PNG thumbnail, rendered from the pixel
    array (no figure; shared by the interactive plots and the app server).
    With matplotlib this is JAX's ``png_b64`` (``imsave``; one channel takes
    its default colormap).  Without it, the frame is written by
    :func:`png_bytes` as RGB (grey for one channel), each value clipped to
    [0, 1] and scaled to ``uint8`` by truncation of ``x * 255``, the rounding
    matplotlib's RGB path takes."""
    arr = np.clip(np.transpose(np.asarray(frame_chw, np.float32), (1, 2, 0)), 0.0, 1.0)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    try:
        import matplotlib
    except ImportError:
        return base64.b64encode(png_bytes((arr * 255).astype(np.uint8))).decode()
    matplotlib.use("Agg")
    from matplotlib import image as mpimg

    buf = io.BytesIO()
    mpimg.imsave(buf, arr, format="png")
    return base64.b64encode(buf.getvalue()).decode()
