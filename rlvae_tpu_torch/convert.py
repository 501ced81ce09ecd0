"""Weights carried across from the JAX package.

- :func:`load_component_npz` reads a flat component ``.npz`` (keys such as
  ``params/hidden_0/kernel``) into a nested dict; the port's own copy of
  ``rlvae_tpu/data/convert.py:113-123``.
- :func:`from_jax_variables` maps the JAX model's ``variables`` (nested
  numpy arrays) onto the port's state dict: Flax kernels are stored
  ``[in, out]`` and become ``nn.Linear.weight`` ``[out, in]``; the flows'
  ``w0..wL`` / ``b0..bL`` per MADE block keep their ``[in, out]`` layout.
  The masks are recomputed by the port, not carried.
- :func:`params_to_numpy` goes the other way: the port's parameters as a
  nested numpy tree keyed as the JAX ``params``, so tests can compare
  updated parameters with JAX's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch


def load_component_npz(path: str | Path) -> Dict[str, Any]:
    """Load a flat component .npz back into a nested dict of numpy arrays."""
    nested: Dict[str, Any] = {}
    with np.load(path) as zf:
        for key in zf.files:
            parts = key.split("/")
            node = nested
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(zf[key])
    return nested


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # a contiguous copy


def net_state_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{layer: {kernel [in,out], bias}} -> {layer.weight [out,in], layer.bias}."""
    state = {}
    for layer, p in params.items():
        if set(p) != {"kernel", "bias"}:
            raise ValueError(f"unexpected parameters {sorted(p)} in layer {layer!r}")
        state[f"{layer}.weight"] = _tensor(np.asarray(p["kernel"]).T)
        state[f"{layer}.bias"] = _tensor(p["bias"])
    return state


def flows_state_from_jax(flows) -> Dict[str, torch.Tensor]:
    """[[{w0.., b0..} per block] per flow] -> TemporalFlows state entries."""
    state = {}
    for fi, flow in enumerate(flows):
        for bi, block in enumerate(flow):
            for key, value in block.items():
                kind, li = key[0], key[1:]
                if kind not in "wb" or not li.isdigit():
                    raise ValueError(f"unexpected MADE parameter {key!r}")
                field = "weights" if kind == "w" else "biases"
                state[f"flows.{fi}.blocks.{bi}.{field}.{li}"] = _tensor(value)
    return state


def from_jax_variables(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's RlVAE state dict from the JAX model's ``variables``."""
    params = tree["params"] if "params" in tree else tree
    state = {}
    for comp in ("encoder", "decoder"):
        for k, v in net_state_from_flax(params[comp]).items():
            state[f"{comp}.{k}"] = v
    for k, v in flows_state_from_jax(params.get("flows", [])).items():
        state[f"flows.{k}"] = v
    return state


def params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """The RlVAE's parameters keyed as the JAX ``params`` tree: ``encoder`` /
    ``decoder`` ``{layer: {kernel [in, out], bias}}`` and ``flows`` as
    ``[[{w0.., b0..} per block] per flow]``."""
    params: Dict[str, Any] = {"encoder": {}, "decoder": {}, "flows": []}
    for name, p in model.named_parameters():
        a = p.detach().float().cpu().numpy().copy()
        comp, rest = name.split(".", 1)
        if comp in ("encoder", "decoder"):
            layer, kind = rest.rsplit(".", 1)
            params[comp].setdefault(layer, {})["kernel" if kind == "weight" else "bias"] = (
                a.T if kind == "weight" else a)
        elif comp == "flows":
            _, fi, _, bi, field, li = rest.split(".")  # flows.{fi}.blocks.{bi}.{field}.{li}
            flows = params["flows"]
            while len(flows) <= int(fi):
                flows.append([])
            while len(flows[int(fi)]) <= int(bi):
                flows[int(fi)].append({})
            flows[int(fi)][int(bi)][f"{field[0]}{li}"] = a
        else:
            raise ValueError(f"unexpected parameter {name!r}")
    return params


def load_pretrained_net(module: torch.nn.Module, path: str | Path) -> None:
    """Load a component ``.npz`` (``params/<layer>/{kernel,bias}``) into a net."""
    state = net_state_from_flax(load_component_npz(path)["params"])
    current = module.state_dict()
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    expected = {k: tuple(v.shape) for k, v in current.items()}
    if shapes != expected:
        raise ValueError(f"pretrained shapes {shapes} do not match the model's {expected}")
    module.load_state_dict(state)
