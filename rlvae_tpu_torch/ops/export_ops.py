"""The kernels as registered ops, for ``torch.export``.

The kernel wrappers launch through :mod:`ctypes` on raw pointers
(``ops/_launch.py``), which ``torch.export`` cannot trace.  This module
registers the inference kernels of the exported programs as
``torch.library`` custom ops, each with a fake implementation that gives
its output shapes:

- ``rlvae::chol_bundle`` (B1, :func:`~rlvae_tpu_torch.ops.metric_kernels.chol_bundle`),
- ``rlvae::iaf_chain_fwd`` (B2, :func:`~rlvae_tpu_torch.ops.iaf_kernels.iaf_chain_fwd`
  without the residuals, as ``IAFChain`` calls it in inference),
- ``rlvae::metric_bundle`` (B6, :func:`~rlvae_tpu_torch.ops.metric_kernels.metric_bundle`),
- ``rlvae::g_inv`` (B7, :func:`~rlvae_tpu_torch.ops.metric_kernels.g_inv`).

Each op's implementation is its wrapper: the kernel for CUDA tensors, the
plain version for CPU tensors, and no other route.  The wrappers call the
ops only while a program is being exported (``torch.compiler.is_exporting()``),
so the eager path launches as before; inside an exported graph the op
stands where the autograd Function (``CholBundle``, ``IAFChain``, ``GInv``,
``MetricBundleG``) stood, since an inference trace runs the Function's
forward.  Importing this module registers the ops; a saved program that
holds them loads only after that (``rlvae_tpu_torch.export.load_exported``
imports it).  :data:`OP_NAMES` maps each op to the kernel it launches.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.library import custom_op

from rlvae_tpu_torch.ops import iaf_kernels as _iaf
from rlvae_tpu_torch.ops import metric_kernels as _mk

# registered op -> the wrapper (and kernel) it runs
OP_NAMES = {"chol_bundle": "B1", "iaf_chain_fwd": "B2", "metric_bundle": "B6", "g_inv": "B7"}

_D = _mk.KERNEL_DIM


@custom_op("rlvae::chol_bundle", mutates_args=())
def chol_bundle(z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
                inv_t2: float, diag: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _mk.chol_bundle(z, centroids, matrices, inv_t2, diag)


@chol_bundle.register_fake
def _(z, centroids, matrices, inv_t2, diag):
    return z.new_empty((z.shape[0], _D, _D)), z.new_empty((z.shape[0],))


@custom_op("rlvae::g_inv", mutates_args=())
def g_inv(z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
          inv_t2: float, lbd: float) -> torch.Tensor:
    return _mk.g_inv(z, centroids, matrices, inv_t2, lbd)


@g_inv.register_fake
def _(z, centroids, matrices, inv_t2, lbd):
    return z.new_empty((z.shape[0], _D, _D))


@custom_op("rlvae::metric_bundle", mutates_args=())
def metric_bundle(z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
                  inv_t2: float, lbd: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return _mk.metric_bundle(z, centroids, matrices, inv_t2, lbd)


@metric_bundle.register_fake
def _(z, centroids, matrices, inv_t2, lbd):
    b = z.shape[0]
    return (z.new_empty((b, _D, _D)), z.new_empty((b, _D, _D)), z.new_empty((b,)),
            z.new_empty((b, _D, _D)))


@custom_op("rlvae::iaf_chain_fwd", mutates_args=())
def iaf_chain_fwd(z0: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, wh: torch.Tensor,
                  bh: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                  fp_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _iaf.iaf_chain_fwd(z0, w0, b0, wh, bh, wo, bo, fp_iters=fp_iters)


@iaf_chain_fwd.register_fake
def _(z0, w0, b0, wh, bh, wo, bo, fp_iters):
    nt, b, d = w0.shape[0], z0.shape[0], z0.shape[1]
    return z0.new_empty((nt, b, d)), z0.new_empty((nt, b))


def count_in_graph(graph: torch.fx.Graph) -> dict:
    """How many calls of each registered op a program's graph holds, by
    op name (every name of :data:`OP_NAMES`, zeros included)."""
    counts = dict.fromkeys(OP_NAMES, 0)
    for node in graph.nodes:
        target = getattr(node.target, "_schema", None)
        if node.op == "call_function" and target is not None:
            ns, _, name = target.name.partition("::")
            if ns == "rlvae" and name in counts:
                counts[name] += 1
    return counts
