"""Layouts of the data-parallel and DP x TP training step.

Port of ``rlvae_tpu/parallel/sharding.py``.  JAX annotates shardings and
lets GSPMD place the collectives; here each rank of a ``torch.distributed``
world (:mod:`rlvae_tpu_torch.parallel.mesh`) holds its part explicitly and
every collective is a counted call (:mod:`.collectives`):

- :func:`shard_batch` is a rank's contiguous slice of the global batch on
  the data axis, :func:`replicate` a broadcast of the model's parameters
  and buffers from rank 0, :func:`pad_to_devices` JAX's truncation of a
  batch to a multiple of the data axis.
- Tensor parallelism over the model axis: :data:`TP_MIN_PARAM_SIZE` and
  :func:`_param_spec` are JAX's rule, applied to each parameter's shape in
  the port's layout (an ``nn.Linear`` weight is JAX's kernel transposed, so
  the rule picks the same logical dimension: the encoder's 12288-wide
  input, the decoder's 12288-wide output).  :func:`shard_params` makes each
  rank of a model group hold its slice of every parameter the rule shards:

  - an ``nn.Linear`` that the nets apply through ``nets.layers.dense``
    runs tensor-parallel on its slice: sharded over its outputs
    (column-parallel) it computes its columns and all-gathers them;
    sharded over its inputs (row-parallel) it multiplies its slice of the
    input in fp32 from the layer's dtype-rounded operands and all-reduces
    the partial products before the bias and the one rounding to the
    layer's dtype, so the arithmetic is the unsharded layer's up to fp32
    summation order;
  - any other sharded parameter (the MADE kernels that the IAF-chain
    kernels read, a decoder output layer that the fused decode+MSE kernel
    reads, a convolution's kernel) is gathered whole over the model group
    where the model reads it (a ``torch.nn.utils.parametrize``
    parametrization), and its gradient is cut back to the slice, as GSPMD
    gathers around a custom call.  Every kernel still receives whole
    weights.

  The ranks of a model group see the same batch rows and noise, so the
  rest of the step runs replicated on them and their replicated gradients
  agree; gradients are averaged over the data group only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from rlvae_tpu_torch.nets.layers import _IEEELinear
from rlvae_tpu_torch.parallel.collectives import all_gather, all_reduce, broadcast
from rlvae_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous rows of a global batch (numpy or tensor)."""
    n = batch.shape[0]
    if n % mesh.dp != 0:
        raise ValueError(f"{n} rows must divide over the '{DATA_AXIS}' axis ({mesh.dp})")
    per = n // mesh.dp
    return batch[mesh.data_index * per:(mesh.data_index + 1) * per]


def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Every parameter and buffer of ``module`` overwritten with rank 0's,
    in place (the identity without a world)."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            broadcast(t.data, src=0)
    return module


def pad_to_devices(batch, n_devices: int):
    """Drop trailing examples so the batch divides the data axis."""
    n = (batch.shape[0] // n_devices) * n_devices
    return batch[:n]


# ---------------------------------------------------------------------------
# Tensor parallelism over the 'model' axis
# ---------------------------------------------------------------------------

TP_MIN_PARAM_SIZE = 65536  # only shard weights that are worth the collectives


def _param_spec(shape, model_size: int) -> Tuple[Optional[str], ...]:
    """Sharding rule for one parameter: big >=2-D kernels shard their largest
    divisible dim over the model axis; everything else replicates (the
    empty spec)."""
    if len(shape) < 2 or int(np.prod(shape)) < TP_MIN_PARAM_SIZE:
        return ()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for dim in order:
        if shape[dim] % model_size == 0 and shape[dim] >= model_size:
            spec = [None] * len(shape)
            spec[dim] = MODEL_AXIS
            return tuple(spec)
    return ()


def param_shardings(mesh: Mesh, model: nn.Module) -> Dict[str, Optional[int]]:
    """Each parameter's name -> the dim its model-group rank holds a slice of
    (None: replicated), by :func:`_param_spec`."""
    out = {}
    for name, p in model.named_parameters():
        spec = _param_spec(tuple(p.shape), mesh.ep)
        out[name] = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
    return out


def _slice(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    per = x.shape[dim] // mesh.ep
    return x.narrow(dim, mesh.model_index * per, per)


class _Gather(torch.autograd.Function):
    """Forward: the model group's slices concatenated along ``dim``;
    backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh.model_group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.mesh).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    """Forward: this rank's slice along ``dim`` of a replicated tensor;
    backward: the slices' gradients gathered, so every rank holds the whole
    (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _slice(x, dim, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh.model_group, dim=ctx.dim), None, None


class _SumForward(torch.autograd.Function):
    """Forward: the partial sums all-reduced over the model group; backward:
    the identity (the replicated gradient is each partial's)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(), mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Forward: the identity; backward: the partial gradients all-reduced
    over the model group (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh.model_group), None


class _Gathered(nn.Module):
    """Parametrization: the stored parameter is this rank's slice; the model
    reads the whole tensor, gathered over the model group."""

    def __init__(self, mesh: Mesh, dim: int):
        super().__init__()
        self.mesh, self.dim = mesh, dim

    def forward(self, local: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(local, self.mesh, self.dim)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return _slice(full, self.dim, self.mesh).clone()


class ShardedLinear(nn.Linear):
    """An ``nn.Linear`` whose ``weight`` is this rank's slice along
    ``tp_dim`` (0: output features, column-parallel; 1: input features,
    row-parallel); ``nets.layers.dense`` calls :meth:`sharded_dense`."""

    tp_mesh: Mesh
    tp_dim: int

    def sharded_dense(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        mesh, w = self.tp_mesh, self.weight.to(dtype)
        if self.tp_dim == 0:  # column-parallel: this rank's output columns
            x = _SumBackward.apply(x, mesh).to(dtype)
            b = _Scatter.apply(self.bias, mesh, 0).to(dtype)
            y = _IEEELinear.apply(x, w, b) if dtype == torch.float32 else \
                torch.nn.functional.linear(x, w, b)
            return _Gather.apply(y, mesh, y.dim() - 1)
        # row-parallel: fp32 partial products of the dtype-rounded operands
        xs = _Scatter.apply(x, mesh, x.dim() - 1).to(dtype).float()
        part = _IEEELinear.apply(xs, w.float(), None)
        y = _SumForward.apply(part, mesh) + self.bias.to(dtype).float()
        return y.to(dtype)


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def full_name(name: str) -> str:
    """A parameter's or state entry's name with the parametrization's
    ``parametrizations.<x>.original`` folded back to ``<x>``."""
    return name.replace("parametrizations.", "").replace(".original", "")


@dataclass
class TPLayout:
    """What :func:`shard_params` did: each sharded parameter's (unsharded)
    name -> its sharded dim and how the model reads it (``"column"``,
    ``"row"`` or ``"gather"``)."""

    mesh: Mesh
    sharded: Dict[str, Tuple[int, str]] = field(default_factory=dict)

    def gather_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A state dict (or any name -> tensor dict of the model's
        parameters, such as Adam's moments) under the unsharded names with
        every slice gathered over the model group: collective."""
        out = {}
        for name, v in state.items():
            key = full_name(name)
            if key in self.sharded and torch.is_tensor(v) and v.dim() > 0:
                v = all_gather(v.contiguous(), self.mesh.model_group, dim=self.sharded[key][0])
            out[key] = v
        return out

    def local_state(self, full: Dict[str, Any], names) -> Dict[str, Any]:
        """The inverse: this rank's slices of an unsharded dict, keyed by the
        model's own names ``names``."""
        out = {}
        for name in names:
            key = full_name(name)
            if key not in full:
                continue
            v = full[key]
            if key in self.sharded and torch.is_tensor(v) and v.dim() > 0:
                v = _slice(v, self.sharded[key][0], self.mesh).clone()
            out[name] = v
        return out


def shard_params(mesh: Mesh, model: nn.Module, gather: Tuple[str, ...] = ()) -> TPLayout:
    """Shard ``model``'s parameters over ``mesh``'s model axis in place
    (call it on every rank after :func:`replicate`, before the optimizer is
    made).  ``nn.Linear`` weights run tensor-parallel unless their layer is
    named in ``gather`` (read whole by a kernel: the fused decode+MSE
    output layer); every other sharded parameter is gathered where it is
    read."""
    layout = TPLayout(mesh)
    if mesh.ep == 1:
        return layout
    for name, dim in param_shardings(mesh, model).items():
        if dim is None:
            continue
        owner, attr = _owner(model, name)
        layer = name.rpartition(".")[0]
        if type(owner) is nn.Linear and attr == "weight" and layer not in gather:
            owner.__class__ = ShardedLinear
            owner.tp_mesh, owner.tp_dim = mesh, dim
            owner.weight = nn.Parameter(_slice(owner.weight.detach(), dim, mesh).clone())
            layout.sharded[name] = (dim, "row" if dim == 1 else "column")
        else:
            parametrize.register_parametrization(owner, attr, _Gathered(mesh, dim), unsafe=True)
            layout.sharded[name] = (dim, "gather")
    return layout
