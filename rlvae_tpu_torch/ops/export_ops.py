"""The kernels as registered ops, for ``torch.export``.

The kernel wrappers launch through :mod:`ctypes` on raw pointers
(``ops/_launch.py``), which ``torch.export`` cannot trace.  This module
registers the inference kernels of the exported programs as
``torch.library`` custom ops, each with a fake implementation that gives
its output shapes from its inputs (any latent width):

- ``rlvae::chol_bundle`` (B1, :func:`~rlvae_tpu_torch.ops.metric_kernels.chol_bundle`),
- ``rlvae::iaf_chain_fwd`` (B2, :func:`~rlvae_tpu_torch.ops.iaf_kernels.iaf_chain_fwd`
  without the residuals, as ``IAFChain`` calls it in inference),
- ``rlvae::hmc_terms`` (B4, :func:`~rlvae_tpu_torch.ops.metric_kernels.hmc_terms`),
- ``rlvae::metric_bundle`` (B6, :func:`~rlvae_tpu_torch.ops.metric_kernels.metric_bundle`),
- ``rlvae::g_inv`` (B7, :func:`~rlvae_tpu_torch.ops.metric_kernels.g_inv`),
- ``rlvae::basic_grad`` (B1 once, and its plain VJP) and ``rlvae::energy_grad``
  (B6 once, and its plain VJP), below.

Each op's implementation is its wrapper: the kernel for CUDA tensors, the
plain version for CPU tensors, and no other route.  The wrappers call the
ops only while a program is being exported (``torch.compiler.is_exporting()``),
so the eager path launches as before; inside an exported graph the op
stands where the autograd Function (``CholBundle``, ``IAFChain``, ``GInv``,
``MetricBundleG``) stood, since an inference trace runs the Function's
forward.  Importing this module registers the ops; a saved program that
holds them loads only after that (``rlvae_tpu_torch.export.load_exported``
imports it).  :data:`OP_NAMES` maps each op to the kernel it launches.

Two programs differentiate through the metric: the ``basic`` prior's
gradient ascent on log det G^{-1} (B1) and ``geodesic_exact``'s energy path
(B6, in the body of the energy path's loop op).  Each gradient is one
registered op, ``rlvae::basic_grad`` and ``rlvae::energy_grad``, whose
implementation is the eager gradient itself
(:func:`~rlvae_tpu_torch.samplers.riemannian.basic_grad`,
:func:`~rlvae_tpu_torch.geometry.geodesics.energy_grad`: the kernel's
forward and the autograd Function's recompute VJP), so an exported row is
the eager row bit for bit.  ``torch.export`` cannot hold these gradients as
traced backward graphs: it turns the tensors that autograd saves as
outputs (exp's, the norm's) or inside a composite op (einsum's) into
constants it does not know, and refuses the program; an op's own
``register_autograd`` does not help, since in an export trace a custom
op's outputs carry no autograd history.  B4 has no backward, as in eager
mode (JAX's ``hmc_terms_pallas`` has none either).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.library import custom_op

from rlvae_tpu_torch.ops import iaf_kernels as _iaf
from rlvae_tpu_torch.ops import metric_kernels as _mk

# registered op -> the wrapper (and kernel) it runs
OP_NAMES = {"chol_bundle": "B1", "iaf_chain_fwd": "B2", "hmc_terms": "B4", "metric_bundle": "B6",
            "g_inv": "B7", "basic_grad": "B1", "energy_grad": "B6"}

@custom_op("rlvae::chol_bundle", mutates_args=())
def chol_bundle(z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
                inv_t2: float, diag: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _mk.chol_bundle(z, centroids, matrices, inv_t2, diag)


@chol_bundle.register_fake
def _(z, centroids, matrices, inv_t2, diag):
    b, d = z.shape
    return z.new_empty((b, d, d)), z.new_empty((b,))


@custom_op("rlvae::hmc_terms", mutates_args=())
def hmc_terms(z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
              inv_t2: float, lbd: float, log_eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _mk.hmc_terms(z, centroids, matrices, inv_t2, lbd, log_eps)


@hmc_terms.register_fake
def _(z, centroids, matrices, inv_t2, lbd, log_eps):
    return z.new_empty((z.shape[0],)), torch.empty_like(z)


@custom_op("rlvae::g_inv", mutates_args=())
def g_inv(z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
          inv_t2: float, lbd: float) -> torch.Tensor:
    return _mk.g_inv(z, centroids, matrices, inv_t2, lbd)


@g_inv.register_fake
def _(z, centroids, matrices, inv_t2, lbd):
    b, d = z.shape
    return z.new_empty((b, d, d))


@custom_op("rlvae::metric_bundle", mutates_args=())
def metric_bundle(z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
                  inv_t2: float, lbd: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return _mk.metric_bundle(z, centroids, matrices, inv_t2, lbd)


@metric_bundle.register_fake
def _(z, centroids, matrices, inv_t2, lbd):
    b, d = z.shape
    return (z.new_empty((b, d, d)), z.new_empty((b, d, d)), z.new_empty((b,)),
            z.new_empty((b, d, d)))


@custom_op("rlvae::iaf_chain_fwd", mutates_args=())
def iaf_chain_fwd(z0: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, wh: torch.Tensor,
                  bh: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                  fp_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _iaf.iaf_chain_fwd(z0, w0, b0, wh, bh, wo, bo, fp_iters=fp_iters)


@iaf_chain_fwd.register_fake
def _(z0, w0, b0, wh, bh, wo, bo, fp_iters):
    nt, b, d = w0.shape[0], z0.shape[0], z0.shape[1]
    return z0.new_empty((nt, b, d)), z0.new_empty((nt, b))


def _outside_inference_mode(grad, *tensors: torch.Tensor) -> torch.Tensor:
    """``grad`` on copies of ``tensors`` made outside inference mode, which
    autograd can record (a loaded program runs under
    ``torch.inference_mode``)."""
    with torch.inference_mode(False):
        return grad(*(t.clone() for t in tensors))


def _metric(centroids, matrices, temperature: float, regularization: float):
    from rlvae_tpu_torch.geometry.metric import CentroidMetric

    return CentroidMetric(centroids, matrices, temperature, regularization)


@custom_op("rlvae::basic_grad", mutates_args=())
def basic_grad(z: torch.Tensor, centroids: torch.Tensor, matrices: torch.Tensor,
               temperature: float, regularization: float) -> torch.Tensor:
    from rlvae_tpu_torch.samplers.riemannian import basic_grad as grad

    return _outside_inference_mode(
        lambda z, c, m: grad(_metric(c, m, temperature, regularization), z),
        z, centroids, matrices)


@basic_grad.register_fake
def _(z, centroids, matrices, temperature, regularization):
    return torch.empty_like(z)


@custom_op("rlvae::energy_grad", mutates_args=())
def energy_grad(z0: torch.Tensor, z1: torch.Tensor, interior: torch.Tensor,
                centroids: torch.Tensor, matrices: torch.Tensor, temperature: float,
                regularization: float) -> torch.Tensor:
    from rlvae_tpu_torch.geometry.geodesics import energy_grad as grad

    return _outside_inference_mode(
        lambda a, b, x, c, m: grad(_metric(c, m, temperature, regularization), a, b, x),
        z0, z1, interior, centroids, matrices)


@energy_grad.register_fake
def _(z0, z1, interior, centroids, matrices, temperature, regularization):
    return torch.empty_like(interior)


def count_in_graph(graph: torch.fx.Graph) -> dict:
    """How many calls of each registered op a program's graph holds, by
    op name (every name of :data:`OP_NAMES`, zeros included), the bodies
    of its loop ops (the chains' ``while_loop``) included: a call in a body
    counts once, however many times the loop runs it."""
    counts = dict.fromkeys(OP_NAMES, 0)
    owner = graph.owning_module
    for node in graph.nodes:
        if node.op == "get_attr" and owner is not None:
            sub = getattr(owner, node.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                for name, n in count_in_graph(sub.graph).items():
                    counts[name] += n
        target = getattr(node.target, "_schema", None)
        if node.op == "call_function" and target is not None:
            ns, _, name = target.name.partition("::")
            if ns == "rlvae" and name in counts:
                counts[name] += 1
    return counts
