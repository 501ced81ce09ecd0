"""Ahead-of-time program export: the deployment artifact.

Port of ``rlvae_tpu/export.py``.  A trained model's inference programs are
traced by ``torch.export`` and saved with ``torch.export.save``; a serving
host loads and runs them with torch and the port's registered kernel ops
(:mod:`rlvae_tpu_torch.ops.export_ops`), and no model class
(:mod:`rlvae_tpu_torch.bundle_server`).  One program is exported per (op,
batch bucket), the serving engine's bucketed static shapes, and the loaded
bundle plugs into :class:`~rlvae_tpu_torch.serving.BatchingEngine` through
:meth:`ExportedModel.as_ops`.

Layout on disk::

    <out_dir>/manifest.json          # ops, buckets, shapes, leaves, noise, platforms
    <out_dir>/weights.npz            # the model's tensors, flattened
    <out_dir>/<op>_b<bucket>.pt2     # one saved ExportedProgram each

The program design:

- **Weights are program arguments, not constants**, as JAX's ``_op_table``:
  every program takes the flattened leaves (the state dict, then the
  non-persistent buffers: the MADE masks and the metric bank) and runs the
  model through ``torch.func.functional_call``.  The leaves are stored once
  in ``weights.npz``; :meth:`ExportedModel.set_weights` swaps a checkpoint
  in without re-export.
- **int8** (``quantize="int8"``) is JAX's rule: 2-D float state leaves of at
  least 1024 elements are stored as int8 with a symmetric per-output scale
  and dequantized in-program.  ``nn.Linear`` keeps [out, in] where Flax
  keeps [in, out], so JAX's per-column scale is a per-row scale here, and
  the dequantized weights are JAX's, transposed.
- **Noise is an input of the program.**  The manifest records each op's
  draws (name, distribution, shape per row, and the axis the rows stack
  on: 0, or 1 for a chain's step-major draws [S, rows, ...]) in the order
  the model draws them; :meth:`ExportedModel.run` draws them from a
  ``torch.Generator`` on the bundle's device: ``reconstruct``'s from seed 0
  for the batch's rows, as ``ModelManager.reconstruct(x, seed=0)`` draws
  them, ``generate``'s per row from that row's seed, as
  ``ModelManager.generate_rows`` does; padded rows repeat the last row's
  draws along each draw's row axis.  So a bundle row is the live manager's
  row, on padded buckets too.  The draws are ``randn``, ``rand``,
  ``randint`` and ``categorical`` (``weighted_mixture``'s p ~ exp(-|c|/2),
  computed from the bundle's own centroid leaf); a draw may be an index
  whose centroid the program takes as a model draw (``"gather"``: the
  official chain's start z0 = c[idx]).  Every prior method JAX's
  ``export_model`` exports is exportable, as is every posterior method:
  the chains (``official``, ``hmc``, the ``hmc`` posterior) are one
  ``while_loop`` op each with B4's registered op in its body
  (``utils/loops.py:loop_steps``), ``geodesic_exact``'s 80 Adam steps one
  more, and ``basic``'s and ``geodesic_exact``'s gradients one registered
  op per step (:mod:`~rlvae_tpu_torch.ops.export_ops`).
  ``adaptive`` raises, as it does in JAX's ``export_model``: its sampler
  decides its trajectory length on the host from the whole batch.
- **Platforms.**  A program is traced on the manager's device, but the
  graph is an ATen graph whose only device-specific parts are the devices
  its factory calls name; :func:`load_exported` moves those to the device
  it loads on (``torch.export.passes.move_to_device_pass``).  So one saved
  program runs on every device type that ``platforms`` lists (``cpu``,
  ``cuda``; the manager's by default), the counterpart of JAX's
  multi-platform lowering, and a load on an unlisted one is refused.  The
  registered ops launch the kernels for CUDA tensors and run the plain
  versions for CPU tensors, as the eager wrappers do.

A traced forward runs its Python once: shape checks and the kernel
wrappers' launch counters act at export time only.  The registered ops'
implementations are the wrappers themselves, so a loaded program's
launches count in ``.launches`` again; the profiler counts them by kernel
name either way.

Run: ``python -m rlvae_tpu_torch.export <run_dir> --out <bundle_dir>
[--ops ...] [--buckets 1 8 64] [--device cpu]``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from rlvae_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["export_model", "ExportedModel", "load_exported"]

FORMAT_VERSION = 1
OPS = ("reconstruct", "encode", "decode", "generate")
PLATFORMS = ("cpu", "cuda")
QUANT_MIN_SIZE = 1024  # elements of a 2-D leaf that int8 stores quantized


# -- weights ----------------------------------------------------------------


def _leaves(model: torch.nn.Module) -> Tuple[List[str], List[torch.Tensor], int]:
    """(names, tensors, n_state): the state dict's tensors, then every
    buffer it leaves out (non-persistent: the MADE masks, the metric bank)."""
    state = model.state_dict()
    names = list(state)
    extra = [(n, b) for n, b in model.named_buffers() if n not in state]
    tensors = [state[n] for n in names] + [b for _, b in extra]
    return names + [n for n, _ in extra], [t.detach() for t in tensors], len(names)


def _quant_plan(leaves: Sequence[np.ndarray], n_state: int, quantize: Optional[str]) -> List[int]:
    """Indices of the leaves ``int8`` stores quantized: the 2-D float state
    leaves of at least :data:`QUANT_MIN_SIZE` elements (JAX's ``_quant_plan``;
    biases, statistics and the fixed buffers stay exact)."""
    if quantize is None:
        return []
    if quantize != "int8":
        raise ValueError(f"unknown quantization mode {quantize!r}; use 'int8'")
    return [i for i, leaf in enumerate(leaves[:n_state])
            if np.issubdtype(leaf.dtype, np.floating) and leaf.ndim == 2
            and leaf.size >= QUANT_MIN_SIZE]


def _pack_leaves(leaves: Sequence[np.ndarray], plan) -> List[np.ndarray]:
    """The leaves with each planned one replaced by ``(int8 q, fp32 scale
    per output row)``: w ~ q * scale[:, None], JAX's ``_pack_leaves`` on the
    transposed layout."""
    plan = set(plan)
    packed = []
    for i, leaf in enumerate(leaves):
        if i in plan:
            w = np.asarray(leaf, np.float32)
            scale = np.maximum(np.abs(w).max(axis=1), np.float32(1e-12)) / np.float32(127.0)
            packed.append(np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8))
            packed.append(scale.astype(np.float32))
        else:
            packed.append(np.asarray(leaf))
    return packed


def dequantize(packed: Sequence[torch.Tensor], plan, dtypes: Sequence[torch.dtype]
               ) -> List[torch.Tensor]:
    """Packed leaves -> the model's leaves; each quantized pair becomes
    ``(q.float() * scale[:, None]).to(dtype)``.  Runs inside the programs."""
    plan = set(plan)
    out, j = [], 0
    for i, dtype in enumerate(dtypes):
        if i in plan:
            q, scale = packed[j], packed[j + 1]
            out.append((q.to(torch.float32) * scale[:, None]).to(dtype))
            j += 2
        else:
            out.append(packed[j])
            j += 1
    return out


# -- noise ------------------------------------------------------------------


def _categorical_probs(spec: Mapping[str, Any], leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The probabilities of a ``categorical`` draw, from the bundle's own
    weight leaf, as the model computes them (``weighted_mixture``'s
    p ~ exp(-|c| / 2) over the centroids)."""
    if spec.get("probs") != "softmax(-|c|/2)":
        raise ValueError(f"unknown categorical probabilities {spec.get('probs')!r}")
    c = leaves[spec["leaf"]]
    return torch.softmax(-torch.linalg.vector_norm(c, dim=-1) / 2.0, dim=0)


def _draw(spec: Mapping[str, Any], rows: int, generator: torch.Generator, device,
          leaves: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
    kind, shape, axis = spec["kind"], list(spec["shape"]), spec.get("row_axis", 0)
    shape = tuple(shape[:axis] + [rows] + shape[axis:])
    if kind == "randn":
        return torch.randn(shape, generator=generator, device=device)
    if kind == "rand":
        return torch.rand(shape, generator=generator, device=device)
    if kind == "randint":
        return torch.randint(0, spec["high"], shape, generator=generator, device=device)
    if kind == "categorical":
        if len(shape) != 1:
            raise ValueError("a categorical draw is one index per row")
        return torch.multinomial(_categorical_probs(spec, leaves), rows, replacement=True,
                                 generator=generator)
    raise ValueError(f"unknown draw {kind!r}")


def draw_noise(spec: Sequence[Mapping[str, Any]], rows: int, generator: torch.Generator,
               device, leaves: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """The draws of a manifest noise ``spec`` for ``rows`` rows from one
    generator, in the spec's order: each entry its ``shape`` with the rows
    inserted at its ``row_axis`` (0 by default; 1 for a chain's step-major
    draws, [S, rows, ...]).  ``leaves`` are the bundle's packed weights,
    which a ``categorical`` draw reads its probabilities from."""
    return [_draw(s, rows, generator, device, leaves) for s in spec]


def model_noise(model, spec: Sequence[Mapping[str, Any]],
                draws: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A recipe's draws as the model's noise mapping: a draw with
    ``"gather": name`` is an index whose centroid the model takes as its
    draw ``name`` (the official chain's start z0 = c[idx]).  Runs inside the
    programs."""
    noise = {}
    for s, t in zip(spec, draws):
        if "gather" in s:
            noise[s["gather"]] = model.metric.centroids[t]
        else:
            noise[s["name"]] = t
    return noise


def _posterior_spec(model) -> List[Dict[str, Any]]:
    """The draws of ``model.draw_posterior_noise``: eps [D], and t [1] for a
    Gaussian posterior sampled by ``geodesic`` with a metric, or the
    momenta ``gammas`` [20, D] (step-major) for ``hmc``."""
    from rlvae_tpu_torch.samplers.riemannian import POSTERIOR_HMC_STEPS, POSTERIOR_METHODS

    d = int(model.latent_dim)
    spec = [{"name": "eps", "kind": "randn", "shape": [d]}]
    if model.posterior_type == "riemannian_metric" or model.metric is None \
            or not model.use_riemannian:
        return spec
    method = model.sampling_method
    if method not in POSTERIOR_METHODS:
        raise ValueError(f"Unknown posterior sampling method: {method}")
    if method == "geodesic":
        return spec + [{"name": "t", "kind": "rand", "shape": [1]}]
    if method == "hmc":
        return spec + [{"name": "gammas", "kind": "randn", "shape": [POSTERIOR_HMC_STEPS, d],
                        "row_axis": 1}]
    return spec


def _generation_spec(model, method: str, centroid_leaf: int) -> List[Dict[str, Any]]:
    """The draws of ``model.draw_generation_noise(1, method)``;
    ``centroid_leaf`` is the packed weight index of the metric's centroids."""
    from rlvae_tpu_torch.samplers.hmc import HMCConfig

    d = int(model.latent_dim)
    eps = {"name": "eps", "kind": "randn", "shape": [d]}
    metric = model.metric
    if metric is None:
        return [eps]
    k = metric.n_centroids
    if method == "adaptive":
        raise ValueError(
            "generate_method 'adaptive' is not exportable: the self-tuning sampler decides its "
            "trajectory length on the host from the whole batch's tuned step sizes (JAX's "
            "export_model refuses it too: it passes no plan, and the decision meets a tracer); "
            "serve it from the live manager")
    randint = {"kind": "randint", "shape": [], "high": k}
    steps = HMCConfig().mcmc_steps
    chain = [{"name": "gammas", "kind": "randn", "shape": [steps, d], "row_axis": 1},
             {"name": "unifs", "kind": "rand", "shape": [steps], "row_axis": 1}]
    specs = {
        "geodesic": [{"name": "i1", **randint}, {"name": "i2", **randint},
                     {"name": "t", "kind": "rand", "shape": [1]}, eps],
        "geodesic_exact": [{"name": "i1", **randint}, {"name": "i2", **randint},
                           {"name": "s", "kind": "rand", "shape": []}, eps],
        "centroid_aware": [{"name": "idx", **randint}, eps],
        "weighted_mixture": [{"name": "idx", "kind": "categorical", "shape": [],
                              "probs": "softmax(-|c|/2)", "leaf": centroid_leaf}, eps],
        "basic": [eps],
        "official": [{"name": "idx", **randint, "gather": "z0"}, *chain],
        "hmc": [{"name": "z0", "kind": "randn", "shape": [d]}, *chain],
    }
    if method not in specs:
        raise ValueError(f"Unknown prior sampling method: {method}")
    return specs[method]


def _check_spec(model, spec, model_draws: Mapping[str, torch.Tensor],
                recipe_draws: Sequence[torch.Tensor]) -> None:
    """The recipe gives the model's own draws, bit for bit."""
    mine = model_noise(model, spec, recipe_draws)
    if list(mine) != list(model_draws) or not all(
            torch.equal(a, b) for a, b in zip(mine.values(), model_draws.values())):
        raise RuntimeError("export noise recipe disagrees with the model's draws "
                           f"({list(mine)} vs {list(model_draws)})")


# -- programs ---------------------------------------------------------------


class _Ops(torch.nn.Module):
    """The model's inference ops as one forward: ``functional_call`` runs a
    module's forward, and every op's weights are this module's."""

    def __init__(self, model: torch.nn.Module, op: str, n_obs: int, method: str,
                 spec: Sequence[Mapping[str, Any]]):
        super().__init__()
        self.model = model
        self.op, self.n_obs, self.method = op, n_obs, method
        self.spec = list(spec)

    def forward(self, *inputs):
        m = self.model
        if self.op == "reconstruct":
            x, *noise = inputs
            return m(x, model_noise(m, self.spec, noise))["recon_x"].float()
        if self.op == "encode":
            return m.encode(inputs[0])["embedding"].float()
        if self.op == "decode":
            return m.decode(inputs[0])["reconstruction"].float()
        return m.generate(inputs[0].shape[0], self.n_obs, self.method,
                          noise=model_noise(m, self.spec, inputs)).float()


class _Program(torch.nn.Module):
    """What ``torch.export`` traces: ``(leaves, *inputs) -> output``, the
    weights arriving as arguments and dequantized in the graph.  The model
    is held outside the module tree, so no tensor of it becomes a constant."""

    def __init__(self, ops: _Ops, names: Sequence[str], plan, dtypes):
        super().__init__()
        self.__dict__["_ops"] = ops  # not a submodule
        self.names = ["model." + n for n in names]
        self.plan, self.dtypes = list(plan), list(dtypes)

    def forward(self, leaves, *inputs):
        params = dict(zip(self.names, dequantize(leaves, self.plan, self.dtypes)))
        return torch.func.functional_call(self._ops, params, inputs, strict=True)


def _example_inputs(op: str, b: int, manifest: Mapping[str, Any], device,
                    leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    c, h, w = manifest["input_dim"]
    gen = torch.Generator(device=device).manual_seed(0)
    noise = draw_noise(manifest["noise"].get(op, []), b, gen, device, leaves)
    if op == "reconstruct":
        return [torch.zeros((b, manifest["n_obs"], c, h, w), device=device), *noise]
    if op == "encode":
        return [torch.zeros((b, c, h, w), device=device)]
    if op == "decode":
        return [torch.zeros((b, manifest["latent_dim"]), device=device)]
    return noise


def _item_spec(op: str, manifest: Mapping[str, Any]) -> Tuple[List[int], str]:
    """(shape of one item, dtype) of what :meth:`ExportedModel.run` takes."""
    c, h, w = manifest["input_dim"]
    return {"reconstruct": ([manifest["n_obs"], c, h, w], "float32"),
            "encode": ([c, h, w], "float32"),
            "decode": ([manifest["latent_dim"]], "float32"),
            "generate": ([], "uint32")}[op]


def export_model(
    manager,
    out_dir: str | Path,
    ops: Sequence[str] = OPS,
    buckets: Sequence[int] = (1, 8, 64),
    n_obs: int = 8,
    generate_method: str = "geodesic",
    platforms: Optional[Sequence[str]] = None,
    quantize: Optional[str] = None,
) -> Dict[str, Any]:
    """Export a :class:`~rlvae_tpu_torch.inference.ModelManager`'s inference
    programs to ``out_dir``, traced on the manager's device; returns the
    manifest.  ``platforms`` lists the device types the programs may load on
    (module docstring); ``quantize="int8"`` stores the large 2-D weights as
    int8 with per-output scales (about 4x smaller ``weights.npz``)."""
    unknown = set(ops) - set(OPS)
    if unknown:
        raise KeyError(f"unknown ops {sorted(unknown)}; have {sorted(OPS)}")
    platforms = list(platforms) if platforms else [manager.device.type]
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"unknown platforms {bad}; have {list(PLATFORMS)}")
    model, device = manager.model, manager.device
    names, tensors, n_state = _leaves(model)
    leaves = [t.cpu().numpy() for t in tensors]
    plan = _quant_plan(leaves, n_state, quantize)
    packed = _pack_leaves(leaves, plan)
    args = tuple(torch.from_numpy(p).to(device) for p in packed)

    noise: Dict[str, Any] = {}
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)  # noqa: E731
    if "reconstruct" in ops:
        spec = _posterior_spec(model)
        _check_spec(model, spec, model.draw_posterior_noise(3, gen(0)),
                    draw_noise(spec, 3, gen(0), device, args))
        noise["reconstruct"] = spec
    if "generate" in ops:
        centroid_leaf = (names.index("metric_centroids") if "metric_centroids" in names else -1)
        centroid_leaf += sum(1 for i in plan if i < centroid_leaf)  # int8 leaves pack as two
        spec = _generation_spec(model, generate_method, centroid_leaf)
        _check_spec(model, spec, model.draw_generation_noise(1, generate_method, gen(7)),
                    draw_noise(spec, 1, gen(7), device, args))
        noise["generate"] = spec

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "weights.npz", **{str(i): leaf for i, leaf in enumerate(packed)})

    manifest: Dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "platforms": platforms,
        "traced_on": device.type,
        "n_obs": int(n_obs),
        "generate_method": generate_method,
        "input_dim": [int(s) for s in model.input_dim],
        "latent_dim": int(model.latent_dim),
        "buckets": [int(b) for b in buckets],
        "n_weight_leaves": len(packed),
        "leaf_names": names,
        "n_state_leaves": n_state,
        "leaf_dtypes": [str(t.dtype) for t in tensors],
        "quantization": ({"mode": quantize, "leaf_indices": [int(i) for i in plan]}
                         if quantize else None),
        "noise": noise,
        "programs": {},
    }
    from rlvae_tpu_torch.ops.export_ops import count_in_graph

    for op in ops:
        program = _Program(_Ops(model, op, int(n_obs), generate_method, noise.get(op, [])),
                           names, plan, [t.dtype for t in tensors])
        item_shape, in_dtype = _item_spec(op, manifest)
        entries = {}
        for b in buckets:
            with torch.no_grad():
                ep = torch.export.export(
                    program, (args, *_example_inputs(op, int(b), manifest, device, args)))
            fname = f"{op}_b{int(b)}.pt2"
            ep.example_inputs = None  # the weights ride in weights.npz, not in each program
            torch.export.save(ep, out / fname)
            (val,) = [n.meta["val"] for n in ep.graph.output_node().args[0]]
            entries[str(int(b))] = {
                "file": fname,
                "in_shape": [int(b), *item_shape],
                "in_dtype": in_dtype,
                "out_shape": [int(s) for s in val.shape],
                "out_dtype": str(val.dtype).replace("torch.", ""),
                "registered_ops": count_in_graph(ep.graph),
            }
        manifest["programs"][op] = entries
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return manifest


class ExportedModel:
    """A loaded export bundle: callable programs on one device, no model code.

    ``run(op, batch)`` dispatches to the smallest exported bucket that fits,
    padding by repeating the last row (and its draws) and slicing the result
    back, as the serving engine does."""

    def __init__(self, manifest: Dict[str, Any], programs: Dict[str, Dict[int, Callable]],
                 weights: Sequence[torch.Tensor], device: torch.device):
        self.manifest = manifest
        self.device = device
        self._programs = programs
        self._weights = tuple(weights)

    @property
    def ops(self) -> Tuple[str, ...]:
        return tuple(sorted(self._programs))

    def buckets(self, op: str) -> Tuple[int, ...]:
        return tuple(sorted(self._programs[op]))

    def _inputs(self, op: str, batch: np.ndarray, n: int, b: int) -> List[torch.Tensor]:
        spec = self.manifest["noise"].get(op, [])
        dev, w = self.device, self._weights
        axes = [s.get("row_axis", 0) for s in spec]
        if op == "generate":
            seeds = [int(s) for s in batch.reshape(-1)]
            rows = [draw_noise(spec, 1, torch.Generator(device=dev).manual_seed(s), dev, w)
                    for s in seeds]
            draws = [torch.cat(parts, dim=a) for parts, a in zip(zip(*rows), axes)]
            inputs = []
        else:
            inputs = [torch.from_numpy(np.ascontiguousarray(batch)).to(dev)]
            draws = (draw_noise(spec, n, torch.Generator(device=dev).manual_seed(0), dev, w)
                     if spec else [])
        inputs, axes = inputs + draws, [0] * len(inputs) + axes
        if b > n:  # the last row, and its draws along their row axes, repeated
            inputs = [torch.cat([t, t.narrow(a, n - 1, 1).expand(
                *t.shape[:a], b - n, *t.shape[a + 1:])], dim=a) for t, a in zip(inputs, axes)]
        return inputs

    def run_rows(self, op: str, batch) -> torch.Tensor:
        """:meth:`run` as a tensor on the bundle's device, without waiting for it."""
        if op not in self._programs:
            raise KeyError(f"unknown op {op!r}; have {self.ops}")
        progs = self._programs[op]
        n = int(np.shape(batch)[0])
        if n == 0:
            raise ValueError(f"empty batch for {op!r}")
        fit = [b for b in progs if b >= n]
        if not fit:
            raise ValueError(
                f"batch {n} exceeds the largest exported bucket {max(progs)} for {op!r}")
        b = min(fit)
        spec = self.manifest["programs"][op][str(b)]
        x = np.asarray(batch, dtype=np.dtype(spec["in_dtype"]))
        with torch.inference_mode():
            return progs[b](self._weights, *self._inputs(op, x, n, b))[:n]

    def run(self, op: str, batch) -> np.ndarray:
        return self.run_rows(op, batch).float().cpu().numpy()

    def set_weights(self, state) -> None:
        """Swap in another checkpoint of the same architecture (a state dict,
        a checkpoint slot's ``params``, or a module) without re-exporting any
        program; the leaves are program arguments.  A quantized bundle
        re-quantizes them under the exported plan.  The non-persistent
        buffers (masks, metric bank) stay the bundle's."""
        if isinstance(state, torch.nn.Module):
            state = state.state_dict()
        m = self.manifest
        n_state = m["n_state_leaves"]
        names = m["leaf_names"][:n_state]
        if set(state) != set(names):
            raise ValueError(
                f"expected the {n_state} state leaves of the exported model, got "
                f"{len(state)} leaves ({len(set(names) - set(state))} missing, "
                f"{len(set(state) - set(names))} unknown)")
        new = []
        for name, dtype, old_shape in zip(names, m["leaf_dtypes"], self._state_shapes()):
            t = torch.as_tensor(state[name]).detach()
            if tuple(t.shape) != old_shape:
                raise ValueError(f"weight leaf {name} shape {tuple(t.shape)} != exported "
                                 f"{old_shape}")
            if str(t.dtype) != dtype:
                # the programs' signature is dtype-exact: fail here, not at the next run
                raise ValueError(f"weight leaf {name} dtype {t.dtype} != exported {dtype}")
            new.append(t.cpu().numpy())
        plan = (m.get("quantization") or {}).get("leaf_indices", [])
        packed = _pack_leaves(new, plan)
        n_fixed = m["n_weight_leaves"] - len(packed)
        self._weights = (tuple(torch.from_numpy(p).to(self.device) for p in packed)
                         + self._weights[len(self._weights) - n_fixed:])

    def _state_shapes(self) -> List[Tuple[int, ...]]:
        """The shape of each state leaf, read through the packing."""
        plan = set((self.manifest.get("quantization") or {}).get("leaf_indices", []))
        shapes, j = [], 0
        for i in range(self.manifest["n_state_leaves"]):
            shapes.append(tuple(self._weights[j].shape))
            j += 2 if i in plan else 1
        return shapes

    def as_ops(self, ops: Optional[Sequence[str]] = None) -> Dict[str, Callable]:
        """Op table for :class:`~rlvae_tpu_torch.serving.BatchingEngine`:
        serve the bundle with dynamic batching and no model code."""
        names = list(ops) if ops is not None else list(self.ops)
        return {op: (lambda batch, _op=op: self.run(_op, batch)) for op in names}


def load_exported(out_dir: str | Path, device: DeviceLike = None) -> ExportedModel:
    """Load a bundle written by :func:`export_model` onto ``device`` (the
    card by default), which must be of a type the manifest's ``platforms``
    lists."""
    from rlvae_tpu_torch.ops import export_ops  # noqa: F401  registers the programs' ops

    dev = resolve_device(device)
    out = Path(out_dir)
    manifest = json.loads((out / "manifest.json").read_text())
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported export format {manifest.get('format_version')!r}")
    if dev.type not in manifest["platforms"]:
        raise ValueError(f"the bundle was exported for {manifest['platforms']}, not {dev.type}")
    with np.load(out / "weights.npz") as z:
        weights = [torch.from_numpy(z[str(i)]).to(dev)
                   for i in range(manifest["n_weight_leaves"])]
    programs: Dict[str, Dict[int, Callable]] = {}
    for op, entries in manifest["programs"].items():
        programs[op] = {}
        for b, spec in entries.items():
            ep = torch.export.load(out / spec["file"])
            if dev.type != manifest["traced_on"]:
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, dev)
            programs[op][int(b)] = ep.module()
    return ExportedModel(manifest, programs, weights, dev)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Export a trained run's inference programs.")
    ap.add_argument("run_dir", help="training run directory (with checkpoints/)")
    ap.add_argument("--out", required=True, help="output bundle directory")
    ap.add_argument("--slot", default="best", choices=["best", "last"])
    ap.add_argument("--ops", nargs="+", default=list(OPS))
    ap.add_argument("--buckets", nargs="+", type=int, default=[1, 8, 64])
    ap.add_argument("--n-obs", type=int, default=8)
    ap.add_argument("--method", default="geodesic",
                    help="prior sampling method of the generate op: geodesic, centroid_aware, "
                         "weighted_mixture, geodesic_exact, basic, official or hmc (adaptive "
                         "does not export, as in JAX's export_model)")
    ap.add_argument("--platforms", nargs="*", default=None,
                    help="device types the bundle may load on, e.g. cpu cuda "
                         "(default: the export device's)")
    ap.add_argument("--device", default=None, help="export device (default: the card)")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="int8 weight-only storage of the large 2-D weights")
    args = ap.parse_args(argv)

    from rlvae_tpu_torch.inference import ModelManager

    mgr = ModelManager.from_run(args.run_dir, slot=args.slot, device=args.device)
    manifest = export_model(mgr, args.out, ops=tuple(args.ops), buckets=tuple(args.buckets),
                            n_obs=args.n_obs, generate_method=args.method,
                            platforms=args.platforms, quantize=args.quantize)
    progs = sum((Path(args.out) / spec["file"]).stat().st_size
                for entries in manifest["programs"].values() for spec in entries.values())
    weights = (Path(args.out) / "weights.npz").stat().st_size
    print(f"[export] {len(manifest['programs'])} ops x {len(args.buckets)} buckets -> "
          f"{args.out} (programs {progs / 1e6:.1f} MB + weights {weights / 1e6:.1f} MB, "
          f"platforms={manifest['platforms']})")
    # smoke: reload and run the smallest bucket of each op
    loaded = load_exported(args.out, device=mgr.device)
    for op in loaded.ops:
        b = loaded.buckets(op)[0]
        spec = manifest["programs"][op][str(b)]
        y = loaded.run(op, np.zeros(spec["in_shape"], np.dtype(spec["in_dtype"])))
        print(f"[export] {op}: {spec['in_shape']} -> {list(y.shape)} OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
