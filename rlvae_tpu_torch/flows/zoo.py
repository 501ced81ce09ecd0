"""More normalizing flows: MAF, planar, radial, and one handle over them.

Port of ``rlvae_tpu/flows/zoo.py:35-222``:

- MAF, the mirror of the IAF (:class:`MAF`, a stack of the port's
  :class:`~rlvae_tpu_torch.flows.made.MADE` blocks): the density direction
  (:func:`maf_forward`) is one parallel MADE pass per block, y = (x - mu) *
  exp(-s), then a flip of the dims; the sampling direction
  (:func:`maf_inverse`) takes the blocks in reverse order, flips, and runs
  the D-step autoregressive loop x_i = y_i exp(s_i) + mu_i.
- Planar: y = x + u_hat tanh(w^T x + b), with u_hat = u + (softplus(w^T u)
  - 1 - w^T u) w / (|w|^2 + 1e-8), which keeps the map invertible.
- Radial: y = x + beta h(alpha, r) (x - x0), h = 1 / (alpha + r), alpha =
  exp(log_alpha), beta = -alpha + softplus(beta_raw).
- :class:`NormalizingFlow` over ``iaf``/``maf``/``planar``/``radial``, with
  JAX's two-file save layout: ``model.npz`` with one ``leaf_{i}`` per array
  in JAX's leaf order (each MADE block's ``b0..bL`` then ``w0..wL``, keys
  sorted; planar ``b, u, w``; radial ``beta_raw, log_alpha, x0``) and
  ``model_config.json``, so a directory saved by either package loads in
  the other.

Planar and radial parameters are dicts of tensors, as JAX's are; MAF and
IAF parameters are modules.  These flows reach no Pallas kernel in JAX, so
they run as plain PyTorch ops on either device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rlvae_tpu_torch.device import DeviceLike, resolve_device
from rlvae_tpu_torch.flows.iaf import IAF, iaf_forward, iaf_inverse
from rlvae_tpu_torch.flows.made import MADE

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# MAF
# ---------------------------------------------------------------------------


class MAF(nn.Module):
    """``n_blocks`` MADE blocks of ``n_hidden`` hidden layers of ``hidden_size``."""

    def __init__(self, input_dim: int, hidden_size: int = 128, n_blocks: int = 2,
                 n_hidden: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            MADE(input_dim, [hidden_size] * n_hidden, generator) for _ in range(n_blocks))

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        return maf_forward(self, x)


def init_maf(input_dim: int, hidden_size: int = 128, n_blocks: int = 2, n_hidden: int = 3,
             generator: Optional[torch.Generator] = None) -> MAF:
    return MAF(input_dim, hidden_size, n_blocks, n_hidden, generator)


def maf_forward(maf: MAF, x: Tensor) -> Tuple[Tensor, Tensor]:
    """Density direction: one parallel pass per block."""
    logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for block in maf.blocks:
        mu, s = block(x)
        x = (x - mu) * torch.exp(-s)
        logdet = logdet - s.sum(-1)
        x = torch.flip(x, dims=(1,))
    return x, logdet


def maf_inverse(maf: MAF, y: Tensor) -> Tuple[Tensor, Tensor]:
    """Sampling direction: the D-step autoregressive loop per block."""
    logdet = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
    for block in reversed(maf.blocks):
        y = torch.flip(y, dims=(1,))
        x = torch.zeros_like(y)
        ld = torch.zeros_like(logdet)
        for i in range(y.shape[-1]):
            mu, s = block(x)
            x = x.clone()
            x[:, i] = y[:, i] * torch.exp(s[:, i]) + mu[:, i]
            ld = ld + s[:, i]
        y = x
        logdet = logdet + ld
    return y, logdet


# ---------------------------------------------------------------------------
# Planar and radial
# ---------------------------------------------------------------------------


def init_planar(input_dim: int, generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
    scale = 0.01
    return {"w": scale * torch.randn(input_dim, generator=generator),
            "u": scale * torch.randn(input_dim, generator=generator),
            "b": torch.zeros(())}


def planar_forward(params: Dict[str, Tensor], x: Tensor) -> Tuple[Tensor, Tensor]:
    w, u, b = params["w"], params["u"], params["b"]
    wu = torch.dot(w, u)
    u_hat = u + (F.softplus(wu) - 1.0 - wu) * w / (torch.dot(w, w) + 1e-8)
    lin = x @ w + b  # [B]
    y = x + u_hat[None, :] * torch.tanh(lin)[:, None]
    psi = (1.0 - torch.tanh(lin) ** 2)[:, None] * w[None, :]
    logdet = torch.log(torch.abs(1.0 + psi @ u_hat) + 1e-8)
    return y, logdet


def init_radial(input_dim: int, generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
    return {"x0": 0.01 * torch.randn(input_dim, generator=generator),
            "log_alpha": torch.zeros(()), "beta_raw": torch.zeros(())}


def radial_forward(params: Dict[str, Tensor], x: Tensor) -> Tuple[Tensor, Tensor]:
    d = x.shape[-1]
    x0, alpha = params["x0"], torch.exp(params["log_alpha"])
    beta = -alpha + F.softplus(params["beta_raw"])  # beta >= -alpha: invertible
    diff = x - x0[None, :]
    r = torch.linalg.vector_norm(diff, dim=-1)  # [B]
    h = 1.0 / (alpha + r)
    y = x + (beta * h)[:, None] * diff
    h_prime = -(h ** 2)
    logdet = (d - 1) * torch.log1p(beta * h) + torch.log1p(beta * h + beta * h_prime * r)
    return y, logdet


# ---------------------------------------------------------------------------
# Leaves in JAX's order
# ---------------------------------------------------------------------------


def _made_leaves(block: MADE) -> List[Tensor]:
    """One block's arrays in the order of its JAX dict's sorted keys."""
    named = {f"w{i}": w for i, w in enumerate(block.weights)}
    named.update({f"b{i}": b for i, b in enumerate(block.biases)})
    return [named[k] for k in sorted(named)]


def flow_leaves(params) -> List[Tensor]:
    """The arrays of a flow's parameters in JAX's tree-leaf order: a MAF or
    IAF block by block, a planar or radial dict by sorted key."""
    if isinstance(params, (MAF, IAF)):
        return [leaf for block in params.blocks for leaf in _made_leaves(block)]
    if isinstance(params, dict):
        return [params[k] for k in sorted(params)]
    raise TypeError(f"not a flow's parameters: {type(params).__name__}")


def flow_param_count(params) -> int:
    return sum(int(np.prod(leaf.shape)) for leaf in flow_leaves(params))


# ---------------------------------------------------------------------------
# The unified handle
# ---------------------------------------------------------------------------


class NormalizingFlow:
    """One handle over the flow families (JAX's ``NormalizingFlow``).

    ``forward`` maps data toward the prior, returning (y, log|det J|);
    ``inverse`` maps prior samples back (planar and radial have no closed
    inverse and raise, as JAX's do).  Parameters are drawn from a CPU
    generator seeded with ``seed`` (JAX draws from its ``key``; the draws
    differ) unless ``params`` are given, then moved to ``device`` (the card
    unless another device is named)."""

    FAMILIES = ("iaf", "maf", "planar", "radial")

    def __init__(self, family: str, input_dim: int, seed: int = 0, hidden_size: int = 128,
                 n_blocks: int = 2, n_hidden: int = 3, params=None,
                 device: DeviceLike = None):
        if family not in self.FAMILIES:
            raise ValueError(f"family must be one of {self.FAMILIES}")
        self.family = family
        self.input_dim = input_dim
        self.device = resolve_device(device)
        self.meta = {"family": family, "input_dim": input_dim, "hidden_size": hidden_size,
                     "n_blocks": n_blocks, "n_hidden": n_hidden}
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            if family == "iaf":
                params = IAF(input_dim, hidden_size, n_blocks, n_hidden, gen)
            elif family == "maf":
                params = init_maf(input_dim, hidden_size, n_blocks, n_hidden, gen)
            elif family == "planar":
                params = init_planar(input_dim, gen)
            else:
                params = init_radial(input_dim, gen)
        if isinstance(params, nn.Module):
            self.params = params.to(self.device)
        else:
            self.params = {k: torch.as_tensor(v).to(self.device) for k, v in params.items()}
        self._fwd, self._inv = {
            "iaf": (iaf_forward, iaf_inverse), "maf": (maf_forward, maf_inverse),
            "planar": (planar_forward, None), "radial": (radial_forward, None)}[family]

    def _rows(self, x) -> Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def forward(self, x) -> Tuple[Tensor, Tensor]:
        return self._fwd(self.params, self._rows(x))

    def inverse(self, y) -> Tuple[Tensor, Tensor]:
        if self._inv is None:
            raise NotImplementedError(
                f"{self.family} flows have no closed-form inverse (reference raises likewise)")
        return self._inv(self.params, self._rows(y))

    def save(self, dir_path) -> None:
        d = Path(dir_path)
        d.mkdir(parents=True, exist_ok=True)
        flat = {f"leaf_{i}": leaf.detach().cpu().numpy()
                for i, leaf in enumerate(flow_leaves(self.params))}
        np.savez(d / "model.npz", **flat)
        (d / "model_config.json").write_text(json.dumps(self.meta))

    @classmethod
    def load(cls, dir_path, device: DeviceLike = None) -> "NormalizingFlow":
        d = Path(dir_path)
        meta = json.loads((d / "model_config.json").read_text())
        nf = cls(meta.pop("family"), meta.pop("input_dim"), **meta, device=device)
        with np.load(d / "model.npz") as zf:
            leaves = [zf[f"leaf_{i}"] for i in range(len(zf.files))]
        targets = flow_leaves(nf.params)
        if len(leaves) != len(targets):
            raise ValueError(f"{len(leaves)} leaves saved for {len(targets)} parameters")
        with torch.no_grad():
            for target, leaf in zip(targets, leaves):
                if tuple(target.shape) != leaf.shape:
                    raise ValueError(f"saved leaf of shape {leaf.shape} for {tuple(target.shape)}")
                target.copy_(torch.from_numpy(np.asarray(leaf, np.float32)))
        return nf
