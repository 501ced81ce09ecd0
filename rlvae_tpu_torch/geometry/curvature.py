"""Gaussian curvature of the latent manifold on a 2-D plane.

Port of ``rlvae_tpu/geometry/curvature.py``.  For the plane z(u) = origin
+ basis @ u (basis [D, 2]) the induced metric is g~(u) = basis^T G(z(u))
basis; its first and second partials come from nested forward-mode
derivatives (``torch.func.jacfwd``, as JAX's ``jax.jacfwd``), and the
curvature from the Brioschi formula in E, F, G = g~_11, g~_12, g~_22.

Nested forward-mode derivatives need a G that is twice differentiable in
forward mode, which the kernel Functions are not (they define a VJP only).
So this module runs the plain path, G = ``inv_psd_small(g_inv_ref(...))``,
on the card as on the CPU: the JAX package makes the same choice and calls
its XLA path ``_g_xla`` here, never its Pallas kernels.  It is that choice,
not a fallback.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.ops import linalg as _lin
from rlvae_tpu_torch.ops.metric_kernels import g_inv_ref


def induced_metric_2d(metric: CentroidMetric, basis: torch.Tensor, origin: torch.Tensor):
    """g~(u) [2, 2] for u [2] on the plane origin + basis @ u."""
    inv_t2 = 1.0 / metric.temperature ** 2

    def g_tilde(u):
        z = origin + basis @ u
        g_full = _lin.inv_psd_small(
            g_inv_ref(z[None, :], metric.centroids, metric.matrices, inv_t2,
                      metric.regularization))[0]
        return basis.T @ g_full @ basis

    return g_tilde


def gaussian_curvature_2d(metric: CentroidMetric, basis: torch.Tensor, origin: torch.Tensor,
                          points2d: torch.Tensor) -> torch.Tensor:
    """Exact Gaussian curvature of the induced 2-D metric at points2d [N, 2] -> [N]."""
    basis, origin = basis.float(), origin.float()
    g_tilde = induced_metric_2d(metric, basis, origin)
    d_g = jacfwd(g_tilde)  # [2, 2, 2]: d g~_ij / d u_k
    dd_g = jacfwd(d_g)  # [2, 2, 2, 2]

    def k_at(u):
        g, dg, ddg = g_tilde(u), d_g(u), dd_g(u)
        e, f, gg = g[0, 0], g[0, 1], g[1, 1]
        e_u, e_v = dg[0, 0, 0], dg[0, 0, 1]
        f_u, f_v = dg[0, 1, 0], dg[0, 1, 1]
        g_u, g_v = dg[1, 1, 0], dg[1, 1, 1]
        e_vv, f_uv, g_uu = ddg[0, 0, 1, 1], ddg[0, 1, 0, 1], ddg[1, 1, 0, 0]
        zero = torch.zeros_like(e)
        m1 = torch.stack([
            torch.stack([-0.5 * e_vv + f_uv - 0.5 * g_uu, 0.5 * e_u, f_u - 0.5 * e_v]),
            torch.stack([f_v - 0.5 * g_u, e, f]),
            torch.stack([0.5 * g_v, f, gg]),
        ])
        m2 = torch.stack([
            torch.stack([zero, 0.5 * e_v, 0.5 * g_u]),
            torch.stack([0.5 * e_v, e, f]),
            torch.stack([0.5 * g_u, f, gg]),
        ])
        det_g = e * gg - f * f
        return (torch.linalg.det(m1) - torch.linalg.det(m2)) / (det_g ** 2 + 1e-12)

    return vmap(k_at)(points2d.float())
