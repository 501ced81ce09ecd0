"""Held-out model evaluation: reconstruction and missing-data imputation.

Port of ``rlvae_tpu/utils/evaluation.py``: the per-frame summed-MSE
reconstruction error averaged over repeated stochastic passes, and the two
missing-data metrics, MSE on the masked-out pixels of observed frames and
MSE on fully masked-out frames (the masks of
:mod:`rlvae_tpu_torch.data.masks`).  Each batch is one forward of the model
on its own device, in inference mode; each metric is a masked reduction of
the same [B, T, ...] reconstruction, summed on the device and read back
once per run.

The posterior noise of each forward comes from ``noise(run, start, rows)``
when given (a mapping as the model's ``draw_posterior_noise`` returns; the
tests pass JAX's draws), else from one ``torch.Generator`` on the model's
device seeded ``seed``, drawn run by run and batch by batch.  It cannot
reproduce JAX's bits (JAX folds its key per run and batch).  Longitudinal
models get a visit index per (run, batch) from ``numpy.random.default_rng(0)``,
as JAX's.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

NoiseFn = Callable[[int, int, int], Mapping[str, torch.Tensor]]


def _takes(model, name: str) -> bool:
    return name in inspect.signature(model.forward).parameters


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _forward_recon(model, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                   noise: Optional[Mapping[str, torch.Tensor]] = None, seq_mask=None,
                   pix_mask=None, vi_index: Optional[int] = None) -> torch.Tensor:
    """The reconstruction of ``x`` [B, T, ...], shaped as ``x``, in fp32."""
    kwargs = {}
    if _takes(model, "epoch"):
        # the default epoch (100) still lands in the warm-up branch of models
        # trained with warmup >= 100: evaluation runs the trained branch
        kwargs["epoch"] = 10**9
    if vi_index is not None and _takes(model, "vi_index"):
        kwargs["vi_index"] = vi_index
    if _takes(model, "seq_mask"):
        kwargs["seq_mask"] = seq_mask
        kwargs["pix_mask"] = pix_mask
    elif seq_mask is not None or pix_mask is not None:
        # a model without mask support must not see the masked-out content,
        # or the imputation metrics leak: zero it before the forward
        if pix_mask is not None:
            x = x * pix_mask
        if seq_mask is not None:
            x = x * seq_mask[:, :, None, None, None]
    out = model(x, noise, generator=generator, **kwargs)
    recon = out.get("recon_x")
    if recon is None:
        recon = out["reconstruction"]
    return recon.float().reshape(x.shape)


def _setup(model, data, seed: int):
    dev = _device(model)
    data = np.asarray(data, np.float32)
    vi_rng = np.random.default_rng(0) if _takes(model, "vi_index") else None
    return dev, data, vi_rng, torch.Generator(device=dev).manual_seed(int(seed))


def _visit(model, vi_rng) -> Optional[int]:
    return int(vi_rng.integers(model.n_obs)) if vi_rng is not None else None


def evaluate_reconstruction(model, data: np.ndarray, seed: int = 0, batch_size: int = 32,
                            n_runs: int = 5, noise: Optional[NoiseFn] = None
                            ) -> Dict[str, float]:
    """Mean per-frame summed MSE over ``n_runs`` stochastic passes."""
    dev, data, vi_rng, gen = _setup(model, data, seed)
    runs = []
    with torch.inference_mode():
        for r in range(n_runs):
            sums = []
            for i in range(0, data.shape[0], batch_size):
                x = torch.from_numpy(data[i:i + batch_size]).to(dev)
                nz = noise(r, i, x.shape[0]) if noise is not None else None
                recon = _forward_recon(model, x, gen, nz, vi_index=_visit(model, vi_rng))
                sums.append(torch.sum((recon - x) ** 2))
            total = torch.stack(sums).cpu().numpy()  # one read-back per run
            runs.append(float(np.sum(total)) / (data.shape[0] * data.shape[1]))
    return {"recon_mse": float(np.mean(runs)), "recon_mse_std": float(np.std(runs)),
            "n_runs": n_runs}


def evaluate_missing(model, data: np.ndarray, seq_mask: np.ndarray, pix_mask: np.ndarray,
                     seed: int = 0, batch_size: int = 32, n_runs: int = 5,
                     noise: Optional[NoiseFn] = None) -> Dict[str, float]:
    """Imputation metrics: summed MSE on (a) the missing pixels of observed
    frames and (b) the fully missing frames, per sequence."""
    dev, data, vi_rng, gen = _setup(model, data, seed)
    seq_mask = np.asarray(seq_mask, np.float32)
    pix_mask = np.asarray(pix_mask, np.float32)
    n_seqs = data.shape[0]
    pix_runs, seq_runs = [], []
    with torch.inference_mode():
        for r in range(n_runs):
            sums = []
            for i in range(0, n_seqs, batch_size):
                x = torch.from_numpy(data[i:i + batch_size]).to(dev)
                sm = torch.from_numpy(seq_mask[i:i + batch_size]).to(dev)
                pm = torch.from_numpy(pix_mask[i:i + batch_size]).to(dev)
                nz = noise(r, i, x.shape[0]) if noise is not None else None
                recon = _forward_recon(model, x, gen, nz, seq_mask=sm, pix_mask=pm,
                                       vi_index=_visit(model, vi_rng))
                b, t = x.shape[0], x.shape[1]
                sq = ((recon - x) ** 2).reshape(b, t, -1)
                miss_pix = (sq * (1.0 - pm.reshape(b, t, -1))).sum(-1)
                frame = sq.sum(-1)
                sums.append(torch.stack([(miss_pix * sm).sum(-1).sum(),
                                         (frame * (1.0 - sm)).sum(-1).sum()]))
            fetched = torch.stack(sums).cpu().numpy()  # one read-back per run
            pix_runs.append(float(sum(p for p, _ in fetched)) / n_seqs)
            seq_runs.append(float(sum(s for _, s in fetched)) / n_seqs)
    return {
        "missing_pixel_mse": float(np.mean(pix_runs)),
        "missing_pixel_mse_std": float(np.std(pix_runs)),
        "missing_frame_mse": float(np.mean(seq_runs)),
        "missing_frame_mse_std": float(np.std(seq_runs)),
        "n_runs": n_runs,
    }
