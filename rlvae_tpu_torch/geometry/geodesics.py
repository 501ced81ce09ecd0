"""Riemannian geodesics on the centroid metric.

Port of ``rlvae_tpu/geometry/geodesics.py``: the analytic derivative of
G^{-1} (``dg_inv``), the Christoffel symbols, the exponential map (RK4 on
``z'' = -Gamma(z)(z', z')``, a fixed step count), the logarithm map (damped
Gauss-Newton shooting through the integrator), discrete geodesics by
minimizing the Riemannian energy over a path's interior points (Adam, a
fixed iteration count), and the Riemannian length of a discrete path.

The JAX package vmaps single points; here every function takes a batch of
rows, so one kernel launch covers every row (and every midpoint) of a step.
What reads the metric:

- each RK4 stage of :func:`exp_map` takes G^{-1} and G of all its rows from
  one metric-bundle launch (``gm.g_inv_and_g``: ``MetricBundleGInvG``);
  ``dg_inv`` and the weights are plain tensor ops, as in JAX;
- :func:`energy_path` and :func:`path_length` read G at the midpoints
  through ``gm.g`` (the metric bundle, ``MetricBundleG``); Adam's gradient
  goes through its recompute VJP;
- :func:`log_map` needs the Jacobian of the shooting map, which JAX takes
  with ``jax.jacfwd``.  The kernel Functions have no JVP, so the port takes
  it in reverse mode through the same Functions: each row is replicated D
  times, the replica i of a row gets the cotangent e_i, and one forward and
  one backward of the integrator per Gauss-Newton iteration give every
  row's D x D Jacobian (exact to rounding, as forward mode is).  The
  Gauss-Newton solve is a plain batched solve, as JAX's ``jnp.linalg.solve``.

Scalars that JAX holds in fp32 (the step h, the Adam bias corrections) are
rounded to fp32 here too.  Everything runs in fp32 IEEE arithmetic (no
TF32: PyTorch's default for fp32 products, which the port keeps).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rlvae_tpu_torch.geometry import metric as gm
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.utils.loops import loop_steps

__all__ = [
    "dg_inv",
    "christoffel",
    "exp_map",
    "log_map",
    "energy_path",
    "geodesic_interpolate",
    "path_length",
]

_F32 = np.float32
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _rows(z) -> Tuple[torch.Tensor, bool]:
    """(z as fp32 rows [B, D], whether it was a single point [D])."""
    z = torch.as_tensor(z).float()
    return (z[None], True) if z.dim() == 1 else (z, False)


def _linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in fp32: i / (n - 1), correctly rounded."""
    return torch.arange(n, dtype=torch.float32, device=device) / float(max(n - 1, 1))


def dg_inv(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """Analytic derivative of the inverse metric: ``out[..., l, i, j] = d
    G^{-1}_{ij} / d z_l`` at z [D] ([D, D, D]) or rows [B, D] ([B, D, D, D]).

    With w_k = exp(-|z-c_k|^2/T^2), d_l G^{-1} = sum_k M_k w_k (-2 (z-c_k)_l / T^2):
    one weighted contraction, itself smoothly differentiable."""
    zb, single = _rows(z)
    diff = zb[:, None, :] - metric.centroids[None, :, :]  # [B, K, D]
    w = gm.weights(metric, zb)  # [B, K]
    t = _F32(metric.temperature)
    coef = float(_F32(-2.0) / (t * t)) * w[:, :, None] * diff  # [B, K, D] (l)
    k, d = diff.shape[1:]
    out = (coef.transpose(1, 2) @ metric.matrices.reshape(k, d * d)).reshape(-1, d, d, d)
    return out[0] if single else out


def christoffel(metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """Christoffel symbols of the second kind: ``out[..., k, i, j] =
    Gamma^k_ij``, symmetric in (i, j), at z [D] or rows [B, D].

    d_l G = -G (d_l G^{-1}) G (exact, from :func:`dg_inv`), and Gamma^k_ij =
    1/2 (G^{-1})^{kl} (d_i G_lj + d_j G_li - d_l G_ij).  G^{-1} and G come
    from one metric-bundle launch for all rows."""
    zb, single = _rows(z)
    gi, g = gm.g_inv_and_g(metric, zb)  # [B, D, D] each
    dgi = dg_inv(metric, zb)  # [B, l, i, j]
    dg = -(g[:, None] @ dgi @ g[:, None])  # [x, l, i, j] = d_l G_ij
    t1 = dg.permute(0, 2, 1, 3)  # d_i G_lj
    t2 = dg.permute(0, 2, 3, 1)  # d_j G_li
    b, d = gi.shape[:2]
    out = 0.5 * (gi @ (t1 + t2 - dg).reshape(b, d, d * d)).reshape(b, d, d, d)
    return out[0] if single else out


def _acceleration(metric: CentroidMetric, z: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Geodesic acceleration a^k = -Gamma^k_ij v^i v^j of rows [B, D]."""
    gam = christoffel(metric, z)  # [B, k, i, j]
    return -((gam @ v[:, None, :, None])[..., 0] @ v[:, :, None])[..., 0]


def exp_map(metric: CentroidMetric, z0: torch.Tensor, v: torch.Tensor, t: float = 1.0,
            n_steps: int = 32, return_path: bool = False):
    """Riemannian exponential map: the geodesic ODE integrated from ``z0``
    with initial velocity ``v`` for time ``t`` (RK4, ``n_steps`` fixed
    steps, one metric-bundle launch per stage for all rows).  Returns the
    endpoint [D] (rows: [B, D]), or with ``return_path`` also the path
    [n_steps + 1, D] ([B, n_steps + 1, D])."""
    z, single = _rows(z0)
    vel, _ = _rows(v)
    h = _F32(t / n_steps)
    half_h, sixth_h = float(_F32(0.5) * h), float(h / _F32(6.0))
    h = float(h)
    zs = [z]
    for _ in range(n_steps):
        k1z, k1v = vel, _acceleration(metric, z, vel)
        k2z = vel + half_h * k1v
        k2v = _acceleration(metric, z + half_h * k1z, k2z)
        k3z = vel + half_h * k2v
        k3v = _acceleration(metric, z + half_h * k2z, k3z)
        k4z = vel + h * k3v
        k4v = _acceleration(metric, z + h * k3z, k4z)
        z = z + sixth_h * (k1z + 2 * k2z + 2 * k3z + k4z)
        vel = vel + sixth_h * (k1v + 2 * k2v + 2 * k3v + k4v)
        zs.append(z)
    end = z[0] if single else z
    if not return_path:
        return end
    path = torch.stack(zs, dim=-2)
    return end, (path[0] if single else path)


def _shoot_jacobian(metric: CentroidMetric, z0: torch.Tensor, v: torch.Tensor, n_steps: int):
    """(exp_map(z0, v) [B, D], its Jacobian in v [B, D, D]): the rows
    replicated D times, replica i of a row backpropagating e_i, in one
    forward and one backward of the integrator."""
    b, d = v.shape
    z0r = z0.repeat_interleave(d, dim=0)
    with torch.enable_grad():
        vr = v.detach().repeat_interleave(d, dim=0).requires_grad_(True)
        out = exp_map(metric, z0r, vr, n_steps=n_steps)
        eye = torch.eye(d, dtype=v.dtype, device=v.device).repeat(b, 1)
        (jt,) = torch.autograd.grad(out, vr, eye)
    return out.detach()[::d], jt.reshape(b, d, d)


def log_map(metric: CentroidMetric, z0: torch.Tensor, z1: torch.Tensor, n_steps: int = 16,
            n_iters: int = 12, damping: float = 1e-3, init: str = "energy") -> torch.Tensor:
    """Riemannian logarithm: the initial velocity v with ``exp_map(z0, v) =
    z1``, by damped Gauss-Newton shooting (``n_iters`` fixed iterations;
    the Jacobian as the module docstring says).  ``init="energy"`` seeds v
    from the initial tangent of an energy-minimized path (120 iterations),
    ``"linear"`` with z1 - z0.  A candidate is kept only when it lowers the
    shooting residual.  z0, z1 [D] or rows [B, D]."""
    a, single = _rows(z0)
    b, _ = _rows(z1)
    d = a.shape[-1]
    if init == "energy":
        path = energy_path(metric, a, b, n_points=n_steps + 1, n_iters=120)
        v = (path[:, 1] - path[:, 0]) * float(n_steps)
    else:
        v = b - a  # exact for a flat metric
    with torch.no_grad():
        err = ((exp_map(metric, a, v, n_steps=n_steps) - b) ** 2).sum(-1)
        eye = torch.eye(d, dtype=torch.float32, device=a.device)
        for _ in range(n_iters):
            end, jac = _shoot_jacobian(metric, a, v, n_steps)
            resid = end - b
            jt = jac.transpose(-1, -2)
            lhs = jt @ jac + damping * eye
            dv = torch.linalg.solve(lhs, (jt @ resid[..., None]))[..., 0]
            v_new = v - dv
            err_new = ((exp_map(metric, a, v_new, n_steps=n_steps) - b) ** 2).sum(-1)
            better = err_new < err
            v = torch.where(better[:, None], v_new, v)
            err = torch.where(better, err_new, err)
    return v[0] if single else v


def _segment_quads(metric: CentroidMetric, paths: torch.Tensor) -> torch.Tensor:
    """d_i^T G(mid_i) d_i of each segment of paths [B, T, D] -> [B, T-1],
    G at every midpoint of every path from one metric-bundle launch."""
    deltas = paths[:, 1:] - paths[:, :-1]
    mids = 0.5 * (paths[:, 1:] + paths[:, :-1])
    b, s, d = deltas.shape
    g_mid = gm.g(metric, mids.reshape(b * s, d)).reshape(b, s, d, d)
    return torch.einsum("xti,xtij,xtj->xt", deltas, g_mid, deltas)


def _segment_energy(metric: CentroidMetric, paths: torch.Tensor) -> torch.Tensor:
    """Discrete Riemannian energy of each path [B, T, D] -> [B]:
    (T-1) sum_i d_i^T G(mid_i) d_i (the midpoint rule)."""
    return (paths.shape[1] - 1) * _segment_quads(metric, paths).sum(-1)


def path_length(metric: CentroidMetric, path: torch.Tensor) -> torch.Tensor:
    """Riemannian length of a discrete path [T, D] (scalar) or paths
    [B, T, D] ([B]): sum_i sqrt(d_i^T G(mid_i) d_i)."""
    path = torch.as_tensor(path).float()
    single = path.dim() == 2
    paths = path[None] if single else path
    out = torch.sqrt(torch.clamp(_segment_quads(metric, paths), min=0.0)).sum(-1)
    return out[0] if single else out


def adam_update(x: torch.Tensor, grad: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                count: int, lr: float):
    """One ``optax.adam(lr)`` step (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)
    at step ``count`` (1-based), in optax's order of operations:
    (x + (-lr) mu_hat / (sqrt(nu_hat) + eps), mu, nu)."""
    return adam_step(x, grad, mu, nu, *adam_corrections(count), lr)


def adam_corrections(count: int):
    """Adam's bias corrections (1 - b1^count, 1 - b2^count) in fp32, as
    optax computes them, as Python floats."""
    return (float(_F32(1) - _F32(ADAM_B1) ** _F32(count)),
            float(_F32(1) - _F32(ADAM_B2) ** _F32(count)))


def adam_step(x, grad, mu, nu, bc1, bc2, lr: float):
    """:func:`adam_update` at the bias corrections ``bc1``, ``bc2``: Python
    floats, or fp32 0-dim CPU tensors holding them, which divide a tensor
    on either device as the floats do (a CPU scalar operand)."""
    mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * (grad * grad) + ADAM_B2 * nu
    update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
    return x + (-lr) * update, mu, nu


def energy_grad(metric: CentroidMetric, z0: torch.Tensor, z1: torch.Tensor,
                interior: torch.Tensor) -> torch.Tensor:
    """The gradient of each path's energy in its interior points [B, P-2, D]
    (rows are independent, so it is the gradient of the sum).  While a
    program is exported, the registered op ``rlvae::energy_grad``, whose
    implementation is this function (:mod:`rlvae_tpu_torch.ops.export_ops`)."""
    if torch.compiler.is_exporting():
        from rlvae_tpu_torch.ops import export_ops

        return export_ops.energy_grad(z0, z1, interior, metric.centroids, metric.matrices,
                                      metric.temperature, metric.regularization)
    with torch.enable_grad():
        x = interior.detach().requires_grad_(True)
        paths = torch.cat([z0[:, None], x, z1[:, None]], dim=1)
        (grad,) = torch.autograd.grad(_segment_energy(metric, paths).sum(), x)
    return grad


def energy_path(metric: CentroidMetric, z0: torch.Tensor, z1: torch.Tensor, n_points: int = 16,
                n_iters: int = 200, lr: float = 0.05) -> torch.Tensor:
    """Discrete geodesic between ``z0`` and ``z1`` [D] (rows: [B, D]): the
    discrete energy minimized over the interior points by Adam (``n_iters``
    fixed steps from the straight line; one metric-bundle launch and one
    recompute VJP per step for all rows), through
    :func:`~rlvae_tpu_torch.utils.loops.loop_steps` (one loop op in an
    exported program), each step's bias corrections a row of a CPU tensor.
    Returns the path [n_points, D] ([B, n_points, D]), endpoints included."""
    a, single = _rows(z0)
    b, _ = _rows(z1)
    ts = _linspace01(n_points, a.device)[1:-1, None]
    x = (1.0 - ts) * a[:, None] + ts * b[:, None]  # [B, n_points - 2, D]
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)

    def step(carry, row):
        x, mu, nu = carry
        bc1, bc2 = row[0]
        return adam_step(x, energy_grad(metric, a, b, x), mu, nu, bc1, bc2, lr), ()

    if n_iters:
        corrections = torch.tensor([adam_corrections(c) for c in range(1, n_iters + 1)],
                                   dtype=torch.float32)
        with torch.no_grad():
            (x, mu, nu), _ = loop_steps(step, (x, mu, nu), (corrections,))
    paths = torch.cat([a[:, None], x, b[:, None]], dim=1)
    return paths[0] if single else paths


def geodesic_interpolate(metric: CentroidMetric, z0: torch.Tensor, z1: torch.Tensor,
                         n_points: int = 10, method: str = "energy", **kwargs) -> torch.Tensor:
    """Geodesic path between latents, endpoints included: [n_points, D]
    (rows: [B, n_points, D]).

    method: ``energy`` (discrete energy minimization, the default),
    ``shooting`` (log_map, then exp_map replayed at k (n_points - 1) steps,
    k = ceil(n_steps / (n_points - 1)), every k-th point), or ``linear``
    (the straight line)."""
    a, single = _rows(z0)
    b, _ = _rows(z1)
    if method == "linear":
        ts = _linspace01(n_points, a.device)[:, None]
        out = (1.0 - ts) * a[:, None] + ts * b[:, None]
    elif method == "energy":
        out = energy_path(metric, a, b, n_points=n_points, **kwargs)
    elif method == "shooting":
        v = log_map(metric, a, b, **kwargs)
        fit_steps = int(kwargs.get("n_steps", 16))
        seg = max(1, n_points - 1)
        k = max(1, -(-fit_steps // seg))
        _, path = exp_map(metric, a, v, n_steps=k * seg, return_path=True)
        out = path[:, ::k]
    else:
        raise ValueError(f"unknown geodesic method {method!r}")
    return out[0] if single else out
