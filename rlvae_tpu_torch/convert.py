"""Weights carried across from the JAX package.

- :func:`load_component_npz` reads a flat component ``.npz`` (keys such as
  ``params/hidden_0/kernel``) into a nested dict; the port's own copy of
  ``rlvae_tpu/data/convert.py:113-123``.
- :func:`from_jax_variables` maps the JAX model's ``variables`` (nested
  numpy arrays: ``params`` and, for nets with BatchNorm, ``stats``) onto
  the port's state dict.  The layer trees nest as the Flax modules do
  (``stage0_block0/conv1`` is ``stage0_block0.conv1``), and each layer maps
  by its leaves:

  - ``Dense`` ``{kernel [in, out], bias}`` -> ``nn.Linear`` ``weight``
    ``[out, in]``, ``bias``;
  - ``Conv`` ``{kernel [kh, kw, in, out] (HWIO), bias}`` -> :class:`Conv`
    ``weight`` ``[out, in, kh, kw]`` (OIHW), ``bias``;
  - ``ConvTranspose`` (the layers named ``deconv_*``, ``up<i>`` and
    ``final``, :func:`is_transposed`) ``{kernel [kh, kw, in, out], bias}``
    -> :class:`ConvTranspose` ``weight`` ``[in, out, kh, kw]``: the kernel
    flipped in H and W, the layout ``F.conv_transpose2d`` correlates
    (``nets/layers.py``);
  - ``BatchNorm`` ``{scale, bias}`` -> ``weight``, ``bias``, and its
    ``stats`` ``{mean, var}`` -> the buffers ``mean``, ``var``;
  - the flows' ``w0..wL`` / ``b0..bL`` per MADE block keep their
    ``[in, out]`` layout.  The masks are recomputed by the port, not
    carried.
- :func:`params_to_numpy` and :func:`stats_to_numpy` go the other way: the
  port's parameters and BatchNorm buffers as nested numpy trees keyed as
  the JAX ``params`` and ``stats``, so tests can compare updated state
  with JAX's.
- :func:`checkpoint_from_jax` turns a JAX checkpoint slot, restored to
  numpy, into the port's slot dict (``train/checkpoints.py``; ``stats``
  become the buffers in ``params``, as the port's state dict holds them), and
  :func:`adam_state_from_jax_opt_leaves` carries JAX's flat optimizer leaves
  onto the port's Adam state by parameter name.  Neither imports JAX: they
  read numpy trees in JAX's flattening order (:func:`jax_leaves`).
- :func:`rhvae_state_from_jax` and :func:`rhvae_params_to_numpy` carry the
  RHVAE's parameters (``encoder``, ``decoder`` and ``metric``, the metric
  net, ``metric_net`` in the port) across in both directions;
  :func:`save_component_npz` writes a net in the flat component format
  :func:`load_component_npz` reads (and JAX's ``load_component_npz`` does).
- :func:`research_state_from_jax` maps the research models' ``params``
  (``LVAE_IAF``, ``LVAE_GUGUS``, ``RIEM``, ``VAMP``, ``GPVAE``, ``LLDM``:
  ``encoder``, ``decoder``, ``flows`` (per visit transition; ``lvaega2``'s
  weight-normed blocks hold ``w<l>_v`` and ``w<l>_g``, the port's
  ``weights`` and ``gains``), ``posterior_flow`` (a block's context
  weight ``cw`` included), the VAMP prior's ``pseudo`` Linear (``kernel``
  [C, prod(input_dim)] and ``bias``, the port's ``pseudo_kernel`` and
  ``pseudo_bias``, in the same layout: the pseudo-inputs are the kernel's
  rows), LLDM's raw ``pseudo_inputs`` and RIEM's empty ``dynamics``) onto
  the port's state dict; a JAX gradient tree maps the same way.
  :func:`ldm_state_from_jax` carries LLDM's frozen eps-net
  (``LatentDiffusion.params``, Flax's ``Dense_0..2``), which JAX keeps
  outside ``params``.  The
  research heads ``SVAEEncoderMLP`` (``hidden_<i>``, ``embedding``,
  ``log_concentration``) and ``DiscriminatorMLP`` (``hidden_<i>``,
  ``out``) are Dense stacks: :func:`net_state_from_flax` carries them.
  :func:`gugus_host_state` copies ``LVAE_GUGUS``'s estimated metrics
  (``gm_list``, ``g_list``, ``sampled_metric``) off a JAX model as numpy,
  and :func:`set_gugus_host_state` puts them on the port's.
- The flow zoo (``rlvae_tpu_torch/flows/zoo.py``, ``batchnorm.py``,
  ``pixelcnn.py``): :func:`zoo_params_from_jax` carries a MAF's or IAF's
  MADE blocks (a state dict for :class:`~rlvae_tpu_torch.flows.zoo.MAF` or
  :class:`~rlvae_tpu_torch.flows.iaf.IAF`) and planar or radial dicts
  (tensors); :func:`flow_batchnorm_from_jax` the flow BatchNorm's
  ``(params, state)``; :func:`pixelcnn_state_from_flax` PixelCNN's Flax
  variables: ``MaskedConv_<i>/Conv_0`` kernels HWIO -> OIHW (the mask stays
  the port's buffer, recomputed), ``BatchNorm_<i>`` ``scale``/``bias`` and
  ``batch_stats`` ``mean``/``var`` -> ``norms.<i>``'s weight, bias and
  running buffers, the 1x1 head ``Conv_0`` -> ``head``.
- :func:`plan_from_jax` turns a calibrated adaptive-sampler plan of the JAX
  package (``calibrate_adaptive_plan``: numpy arrays and Python scalars)
  into the port's plan (tensors on a device), so a JAX plan drives the
  port's planned chain.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

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
    return torch.tensor(np.ascontiguousarray(a, np.float32))  # a contiguous copy


def is_transposed(layer: str) -> bool:
    """Whether the layer of this dotted name is a Flax ``ConvTranspose``:
    the CNN decoder's ``deconv_<i>``/``deconv_out`` and the ResNet
    decoder's ``up<i>``/``final`` (``rlvae_tpu/nets/cnn.py``, ``resnet.py``)."""
    return re.fullmatch(r"deconv_\w+|up\d+|final", layer.rsplit(".", 1)[-1]) is not None


def _layer_leaves(layer: str, p: Mapping[str, Any]) -> Iterator[Tuple[str, np.ndarray]]:
    """One Flax layer's leaves, keys sorted, as (port name, array in the port's layout)."""
    keys = set(p)
    if keys == {"kernel", "bias"}:
        k = np.asarray(p["kernel"])
        if k.ndim == 2:
            w = k.T
        elif k.ndim == 4:
            w = np.flip(k, (0, 1)).transpose(2, 3, 0, 1) if is_transposed(layer) \
                else k.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of shape {k.shape} in layer {layer!r}")
        yield f"{layer}.bias", np.asarray(p["bias"])
        yield f"{layer}.weight", w
    elif keys == {"scale", "bias"}:
        yield f"{layer}.bias", np.asarray(p["bias"])
        yield f"{layer}.weight", np.asarray(p["scale"])
    elif keys == {"mean", "var"}:
        yield f"{layer}.mean", np.asarray(p["mean"])
        yield f"{layer}.var", np.asarray(p["var"])
    else:
        raise ValueError(f"unexpected parameters {sorted(p)} in layer {layer!r}")


def _net_leaves(params: Mapping[str, Any], prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    """A net's ``params`` or ``stats`` tree -> (port name, array), in JAX's
    flattening order (keys sorted at every level)."""
    for name in sorted(params):
        node = params[name]
        if not isinstance(node, Mapping):
            raise ValueError(f"unexpected leaf {prefix}{name!r} outside a layer")
        if all(isinstance(v, Mapping) for v in node.values()):
            yield from _net_leaves(node, f"{prefix}{name}.")
        else:
            yield from _layer_leaves(f"{prefix}{name}", node)


def _flow_leaves(flows) -> Iterator[Tuple[str, np.ndarray]]:
    """[[{w0.., b0..} per block] per flow] -> TemporalFlows names, keys sorted."""
    for fi, flow in enumerate(flows):
        for bi, block in enumerate(flow):
            for key in sorted(block):
                kind, li = key[0], key[1:]
                if kind not in "wb" or not li.isdigit():
                    raise ValueError(f"unexpected MADE parameter {key!r}")
                field = "weights" if kind == "w" else "biases"
                yield f"flows.{fi}.blocks.{bi}.{field}.{li}", np.asarray(block[key])


def net_state_from_flax(params: Mapping[str, Any],
                        stats: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """A Flax net's ``params`` (and ``batch_stats``) -> the port's net state
    dict (module docstring)."""
    return {k: _tensor(a) for k, a in [*_net_leaves(params), *_net_leaves(stats or {})]}


def jax_leaves(params: Mapping[str, Any]) -> List[Tuple[str, np.ndarray]]:
    """Each leaf of a JAX ``params`` tree as (the port's parameter name, the
    array in the port's layout), in the order ``jax.tree_util.tree_leaves``
    flattens the tree: dict keys sorted, lists in order.  That is also the
    order of each moment's leaves in the optax state."""
    leaves = []
    for comp in sorted(params):
        if comp in ("encoder", "decoder"):
            inner = _net_leaves(params[comp])
        elif comp == "flows":
            inner = _flow_leaves(params[comp])
        else:
            raise ValueError(f"unexpected component {comp!r} in the JAX params")
        leaves += [(f"{comp}.{k}", a) for k, a in inner]
    return leaves


def from_jax_variables(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's RlVAE state dict from the JAX model's ``variables``
    (``params``, and ``stats`` where the nets have BatchNorm), or from a
    ``params`` tree alone."""
    params = tree["params"] if "params" in tree else tree
    state = {k: _tensor(a) for k, a in jax_leaves(params)}
    stats = tree.get("stats") if "params" in tree else None
    for comp, net_stats in (stats or {}).items():
        state.update({f"{comp}.{k}": _tensor(a) for k, a in _net_leaves(net_stats or {})})
    return state


def _like(template, leaves: Iterator[Any]):
    """``leaves`` (in flattening order) put into the structure of ``template``."""
    if isinstance(template, Mapping):
        return {k: _like(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return [_like(v, leaves) for v in template]
    leaf = np.asarray(next(leaves))
    if leaf.shape != np.shape(template):
        raise ValueError(f"optimizer leaf of shape {leaf.shape} where the parameter "
                         f"has {np.shape(template)}")
    return leaf


def _adam_state(opt_leaves, params: Mapping[str, Any]) -> Dict[str, Any]:
    if isinstance(opt_leaves, Mapping):
        opt_leaves = [opt_leaves[str(i)] for i in range(len(opt_leaves))]
    n = len(jax_leaves(params))
    if len(opt_leaves) != 3 + 2 * n:
        raise ValueError(f"{len(opt_leaves)} optimizer leaves; the optimizer of "
                         f"{n} parameters has {3 + 2 * n}")
    # InjectHyperparamsState(count, {learning_rate}, (decay: no leaves,
    # ScaleByAdamState(count, mu, nu), scale: no leaves))
    lr, count, moments = opt_leaves[1], opt_leaves[2], opt_leaves[3:]
    mu = jax_leaves(_like(params, iter(moments[:n])))
    nu = jax_leaves(_like(params, iter(moments[n:])))
    step = float(np.asarray(count))  # optax's int32 count is torch's float step
    return {"lr": float(np.asarray(lr)), "state": {
        name: {"step": torch.tensor(step, dtype=torch.float32), "exp_avg": _tensor(m),
               "exp_avg_sq": _tensor(v)}
        for (name, m), (_, v) in zip(mu, nu)}}


def adam_state_from_jax_opt_leaves(opt_leaves, model: torch.nn.Module) -> Dict[str, Any]:
    """The port's optimizer slot from the flat leaves of JAX's optimizer state
    (``opt_leaves`` of a ``last`` checkpoint: a list, or a dict keyed "0",
    "1", ...).  JAX's optimizer is ``inject_hyperparams(chain(
    add_decayed_weights | identity, scale_by_adam, scale))``
    (``rlvae_tpu/train/optim.py:20-30``), whose leaves are the injected
    count, the learning rate, Adam's count, then its first and second
    moments in the parameters' flattening order.  Returns ``{"lr": float,
    "state": {name: {"step", "exp_avg", "exp_avg_sq"}}}``, the moments
    transposed with the kernels they belong to."""
    return _adam_state(opt_leaves, params_to_numpy(model))


def checkpoint_from_jax(restored: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX checkpoint slot (the dict orbax restores: ``variables``,
    ``step``, ``val_loss``, and in ``last`` also ``epoch`` and
    ``opt_leaves``) as the port's slot dict (``params``, ``step``,
    ``val_loss``, and ``epoch`` and ``optimizer`` where JAX has them)."""
    params = restored["variables"]["params"]
    slot: Dict[str, Any] = {"params": from_jax_variables(restored["variables"]),
                            "step": int(restored["step"]),
                            "val_loss": float(restored["val_loss"])}
    if "epoch" in restored:
        slot["epoch"] = int(restored["epoch"])
    if "opt_leaves" in restored:
        slot["optimizer"] = _adam_state(restored["opt_leaves"], params)
    return slot


def _flax_layer(layer: str, kind: str, a: np.ndarray):
    """(Flax leaf name, array in Flax's layout) of the port's ``layer.kind``."""
    if kind in ("mean", "var"):
        return kind, a
    if kind == "bias":
        return "bias", a
    if a.ndim == 1:  # a BatchNorm's weight
        return "scale", a
    if a.ndim == 2:
        return "kernel", a.T
    if is_transposed(layer):
        return "kernel", np.ascontiguousarray(a.transpose(2, 3, 0, 1)[::-1, ::-1])
    return "kernel", a.transpose(2, 3, 1, 0)


def _nest(tree: Dict[str, Any], path: str, key: str, a: np.ndarray) -> None:
    node = tree
    for part in path.split("."):
        node = node.setdefault(part, {})
    node[key] = a


def params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """The RlVAE's parameters keyed as the JAX ``params`` tree: ``encoder`` /
    ``decoder`` as nested Flax layers (``{kernel, bias}``, ``{scale, bias}``)
    in Flax's layouts, and ``flows`` as ``[[{w0.., b0..} per block] per flow]``."""
    params: Dict[str, Any] = {"encoder": net_params_to_numpy(model.encoder),
                              "decoder": net_params_to_numpy(model.decoder), "flows": []}
    for name, p in model.named_parameters():
        comp, rest = name.split(".", 1)
        if comp in ("encoder", "decoder"):
            continue
        if comp == "flows":
            a = p.detach().float().cpu().numpy().copy()
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


def stats_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """The RlVAE's BatchNorm buffers keyed as the JAX ``stats`` tree:
    ``{"encoder": {layer: {mean, var}}, "decoder": {...}}`` (empty for MLP nets)."""
    stats: Dict[str, Any] = {"encoder": {}, "decoder": {}}
    for comp in stats:
        for name, b in getattr(model, comp).named_buffers():
            layer, kind = name.rsplit(".", 1)
            _nest(stats[comp], layer, kind, b.detach().float().cpu().numpy().copy())
    return stats


RHVAE_COMPONENTS = (("encoder", "encoder"), ("decoder", "decoder"), ("metric", "metric_net"))


def rhvae_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's RHVAE state dict from JAX's RHVAE ``params`` (numpy trees
    ``encoder``, ``decoder`` and ``metric``)."""
    return {f"{port}.{k}": _tensor(a) for jax_name, port in RHVAE_COMPONENTS
            for k, a in _net_leaves(params[jax_name])}


def net_params_to_numpy(module: torch.nn.Module) -> Dict[str, Any]:
    """A net's parameters as a Flax ``params`` tree (layers nested by their
    dotted names, Flax's layouts)."""
    tree: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        layer, kind = name.rsplit(".", 1)
        _nest(tree, layer, *_flax_layer(layer, kind, p.detach().float().cpu().numpy().copy()))
    return tree


def rhvae_params_to_numpy(rhvae: torch.nn.Module) -> Dict[str, Any]:
    """The RHVAE's parameters keyed as JAX's ``params``: ``encoder``,
    ``decoder`` and ``metric`` Flax trees."""
    return {jax_name: net_params_to_numpy(getattr(rhvae, port))
            for jax_name, port in RHVAE_COMPONENTS}


def save_component_npz(module: torch.nn.Module, path: str | Path) -> None:
    """Write a net as a flat component ``.npz`` (``params/<layer>/{kernel,
    bias}`` in Flax's layouts), the format :func:`load_pretrained_net` and
    the JAX package's loaders read."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}"
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = v

    walk(net_params_to_numpy(module), "params")
    np.savez(path, **flat)


def load_pretrained_net(module: torch.nn.Module, path: str | Path) -> None:
    """Load a component ``.npz`` (``params/<layer>/{kernel,bias}``) into a net;
    ``ValueError`` when its layers or shapes are not the net's."""
    state = net_state_from_flax(load_component_npz(path)["params"])
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    expected = {k: tuple(v.shape) for k, v in module.named_parameters()}
    if shapes != expected:
        raise ValueError(f"pretrained shapes {shapes} do not match the model's {expected}")
    module.load_state_dict({**module.state_dict(), **state})  # BatchNorm stats stay


def _made_leaves(block: Mapping[str, Any], prefix: str) -> Iterator[Tuple[str, np.ndarray]]:
    """One MADE block's ``w<l>``/``b<l>`` (or weight-normed ``w<l>_v``,
    ``w<l>_g``) and context weight ``cw`` -> the port's names under ``prefix``."""
    fields = {"w": "weights", "b": "biases", "v": "weights", "g": "gains"}
    for key in sorted(block):
        if key == "cw":
            yield f"{prefix}.cw", np.asarray(block[key])
            continue
        m = re.fullmatch(r"([wb])(\d+)(?:_([vg]))?", key)
        if m is None or (m.group(1) == "b" and m.group(3)):
            raise ValueError(f"unexpected MADE parameter {key!r}")
        kind, li, wn = m.groups()
        yield f"{prefix}.{fields[wn or kind]}.{li}", np.asarray(block[key])


def research_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A research model's state dict (``LVAE_IAF``, ``LVAE_GUGUS``,
    ``RIEM``, ``VAMP``, ``GPVAE``, ``LLDM``; LLDM's eps-net comes from
    :func:`ldm_state_from_jax`) from its JAX ``variables`` or ``params``
    tree (or a gradient tree of the same shape)."""
    params = tree["params"] if "params" in tree else tree
    state: Dict[str, np.ndarray] = {}
    for comp in sorted(params):
        node = params[comp]
        if comp in ("encoder", "decoder"):
            state.update((f"{comp}.{k}", a) for k, a in _net_leaves(node))
        elif comp == "flows":
            for fi, flow in enumerate(node):
                for bi, block in enumerate(flow):
                    state.update(_made_leaves(block, f"flows.{fi}.blocks.{bi}"))
        elif comp == "posterior_flow":
            for bi, block in enumerate(node):
                state.update(_made_leaves(block, f"posterior_flow.blocks.{bi}"))
        elif comp == "pseudo":
            state["pseudo_kernel"] = np.asarray(node["kernel"])
            state["pseudo_bias"] = np.asarray(node["bias"])
        elif comp == "pseudo_inputs":
            state["pseudo_inputs"] = np.asarray(node)
        elif comp == "dynamics":
            if node:
                raise ValueError("RIEM's dynamics carry no parameters in the port")
        else:
            raise ValueError(f"unexpected component {comp!r} in the research params")
    return {k: _tensor(a) for k, a in state.items()}


def ldm_state_from_jax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A ``LatentDiffusion``'s state dict from JAX's ``LatentDiffusion.params``
    (the eps-net's ``Dense_0..2``), its keys under ``prefix`` (``"ldm."``
    for an ``LLDM``'s)."""
    return {f"{prefix}net.{k}": v for k, v in net_state_from_flax(params).items()}


def gugus_host_state(model: Any) -> Dict[str, Any]:
    """``LVAE_GUGUS``'s estimated metrics, read off a model of either
    package, as numpy: ``gm_list``, ``g_list`` and the sampled metric's
    (centroids, m_flat, temperature, lbd), or None."""
    sm = model.sampled_metric
    return {
        "gm_list": [np.asarray(g, np.float32) for g in model.gm_list],
        "g_list": [np.asarray(g, np.float32) for g in model.g_list],
        "sampled_metric": None if sm is None else (
            np.asarray(sm.centroids, np.float32), np.asarray(sm.m_flat, np.float32),
            float(sm.temperature), float(sm.lbd)),
    }


def set_gugus_host_state(model: Any, state: Mapping[str, Any]) -> None:
    """The metrics of :func:`gugus_host_state` onto a port ``LVAE_GUGUS``."""
    from rlvae_tpu_torch.models.research.lldm import SampledMetric

    model.gm_list = [np.array(g, np.float32) for g in state["gm_list"]]
    model.g_list = [np.array(g, np.float32) for g in state["g_list"]]
    sm = state["sampled_metric"]
    model.sampled_metric = None if sm is None else SampledMetric(*sm)


def plan_from_jax(plan: Mapping[str, Any], device: Optional[torch.device] = None) -> Dict[str, Any]:
    """A JAX adaptive-sampler plan as the port's: every array (``eps`` [K],
    ``pool`` [P, D], ``pool_eps`` [P]) an fp32 tensor on ``device``, every
    integer scalar (``n_lf``, ``chains``, ``calibration_lf``) an ``int``,
    every other scalar (``accept_rate``, ``path_length``) a ``float``."""
    out: Dict[str, Any] = {}
    for key, value in plan.items():
        arr = np.asarray(value)
        if arr.ndim > 0:
            out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
        elif np.issubdtype(arr.dtype, np.integer):
            out[key] = int(arr)
        else:
            out[key] = float(arr)
    return out


def zoo_params_from_jax(family: str, params):
    """A zoo flow's parameters from JAX's: ``iaf``/``maf`` (a list of MADE
    block dicts) -> a state dict of the port's module (``blocks.<b>.weights.<l>``,
    ``blocks.<b>.biases.<l>``); ``planar``/``radial`` -> a dict of fp32 tensors."""
    if family in ("iaf", "maf"):
        state: Dict[str, np.ndarray] = {}
        for bi, block in enumerate(params):
            state.update(_made_leaves(block, f"blocks.{bi}"))
        return {k: _tensor(a) for k, a in state.items()}
    if family in ("planar", "radial"):
        return {k: _tensor(v) for k, v in params.items()}
    raise ValueError(f"unknown flow family {family!r}")


def flow_batchnorm_from_jax(params: Mapping[str, Any],
                            state: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor],
                                                               Dict[str, torch.Tensor]]:
    """The flow BatchNorm's ``(params, state)`` (``log_gamma``, ``beta``;
    ``running_mean``, ``running_var`` and, after a train forward,
    ``batch_mean``, ``batch_var``) as fp32 tensors."""
    return ({k: _tensor(v) for k, v in params.items()},
            {k: _tensor(v) for k, v in state.items()})


def pixelcnn_state_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A :class:`~rlvae_tpu_torch.flows.pixelcnn.PixelCNN` state dict from
    Flax's ``{"params", "batch_stats"}`` of JAX's ``PixelCNN``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    state: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        m = re.fullmatch(r"(MaskedConv|BatchNorm)_(\d+)|Conv_0", name)
        if m is None:
            raise ValueError(f"unexpected PixelCNN parameter {name!r}")
        if name == "Conv_0":
            state["head.weight"] = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))
            state["head.bias"] = np.asarray(node["bias"])
        elif m.group(1) == "MaskedConv":
            conv = node["Conv_0"]
            state[f"convs.{m.group(2)}.weight"] = np.transpose(np.asarray(conv["kernel"]),
                                                               (3, 2, 0, 1))
            state[f"convs.{m.group(2)}.bias"] = np.asarray(conv["bias"])
        else:
            i = m.group(2)
            state[f"norms.{i}.weight"] = np.asarray(node["scale"])
            state[f"norms.{i}.bias"] = np.asarray(node["bias"])
            state[f"norms.{i}.mean"] = np.asarray(stats[name]["mean"])
            state[f"norms.{i}.var"] = np.asarray(stats[name]["var"])
    return {k: _tensor(a) for k, a in state.items()}
