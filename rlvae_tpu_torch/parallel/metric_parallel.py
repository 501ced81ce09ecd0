"""Centroid-sharded metric evaluation: the expert-parallel (EP) scaling axis.

Port of ``rlvae_tpu/parallel/metric_parallel.py``.  The metric is a K-way
reduction,

    G^{-1}(z) = sum_k M_k exp(-||z - c_k||^2 / T^2) + lbd I,

and in RHVAE the centroid bank is the metric-training subset, so K grows with
the dataset.  Here the bank is split over the ranks of a
``torch.distributed`` world (:mod:`rlvae_tpu_torch.parallel.mesh`):

- each rank holds a contiguous [K/s, D] / [K/s, D, D] slice of the padded
  bank (:func:`shard_metric`) and the rows of z of its data index;
- it computes its partial sums over that slice: for the HMC terms, G^{-1}
  without + lbd I and the gradient contraction v, in one
  :func:`~rlvae_tpu_torch.ops.metric_kernels.hmc_partials` launch on the
  card (its plain version on the CPU);
- one all-reduce (sum) over the model group completes both, as one flat
  [B, D*D + D] buffer (JAX fuses them into one ``psum``);
- the nonlinear rest (+ lbd I, Cholesky, log-det, inverse, G v) runs locally
  on the rank's rows, in plain PyTorch, as JAX runs it in XLA.

Padding: K is padded to a multiple of the shard count with zero matrices and
centroids at 1e6, whose weights underflow to exactly 0, so every padded entry
adds exact zeros.

Every collective goes through :func:`all_reduce_sum` on the caller's process
groups: gloo for CPU tensors (the tests), NCCL for a run with one card per
rank.  Without an initialised world the mesh is 1 x 1 and each all-reduce is
the identity, so one process on one card runs the same code.

The functions take this rank's rows of z and its shard of the bank, as the
body of JAX's ``shard_map`` sees them; :func:`local_rows` and
:func:`shard_metric` cut them from the global arrays.  Only
:func:`sample_prior_hmc_sharded` takes the whole (unpadded) bank and every
row's draws, as JAX's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.ops import linalg as _lin
from rlvae_tpu_torch.ops._launch import plain_route
from rlvae_tpu_torch.ops.metric_kernels import (GInv, fused_supported, g_inv_ref, hmc_partials,
                                                 hmc_partials_ref)
from rlvae_tpu_torch.parallel.collectives import all_reduce
from rlvae_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from rlvae_tpu_torch.samplers.hmc import LOG_EPS, HMCConfig, draw_hmc_noise, run_prior_chain


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh``'s ``axis`` group, in place.

    Every collective of this module is a call of this function, and
    ``all_reduce_sum.calls[axis]`` counts them: one all-reduce each where
    the group exists (through the counted wrapper of :mod:`.collectives`,
    so the audit sees it too), the identity on a 1 x 1 mesh."""
    all_reduce_sum.calls[axis] += 1
    return all_reduce(x, mesh.group(axis))


all_reduce_sum.calls = {DATA_AXIS: 0, MODEL_AXIS: 0}


def pad_metric(metric: CentroidMetric, shards: int) -> CentroidMetric:
    """The bank padded so that ``shards`` divides K: far centroids (1e6)
    with zero matrices, which add exact zeros to every weighted sum."""
    k, d = metric.centroids.shape
    extra = -k % shards
    if extra == 0:
        return metric
    c, m = metric.centroids.float(), metric.matrices.float()
    return CentroidMetric(
        centroids=torch.cat([c, c.new_full((extra, d), 1e6)]),
        matrices=torch.cat([m, m.new_zeros((extra, d, d))]),
        temperature=metric.temperature,
        regularization=metric.regularization,
    )


def shard_metric(mesh: Mesh, metric: CentroidMetric) -> CentroidMetric:
    """This rank's contiguous slice of the padded bank, by model index."""
    padded = pad_metric(metric, mesh.ep)
    per = padded.n_centroids // mesh.ep
    rows = slice(mesh.model_index * per, (mesh.model_index + 1) * per)
    return CentroidMetric(padded.centroids[rows].contiguous(),
                          padded.matrices[rows].contiguous(),
                          padded.temperature, padded.regularization)


def local_rows(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous rows of ``x`` along ``dim``, by data index."""
    n = x.shape[dim]
    if n % mesh.dp != 0:
        raise ValueError(f"{n} rows must divide over the '{DATA_AXIS}' axis ({mesh.dp})")
    per = n // mesh.dp
    return x.narrow(dim, mesh.data_index * per, per).contiguous()


def _partial_terms(metric: CentroidMetric,
                   z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's (G^{-1} partial without + lbd I [B, D, D], scaled gradient
    contraction v = (-2/T^2) sum_k w_k M_k^T (c_k - z) [B, D]): the
    K-proportional part of the HMC terms, one ``hmc_partials`` call on the
    shard's kernel bank (the kernel on CUDA, its plain version on the CPU;
    past the kernel's envelope, D > 32, the plain version, as JAX's
    ``fused_supported`` routes)."""
    t = metric.temperature
    if fused_supported(metric.latent_dim):
        return hmc_partials(z.float().contiguous(), *metric.kernel_bank(), 1.0 / (t * t))
    return plain_route(hmc_partials_ref, z.float().contiguous(), metric.centroids,
                       metric.matrices, 1.0 / (t * t))


def _eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=torch.float32, device=like.device)


def g_inv_sharded(mesh: Mesh, metric: CentroidMetric, z: torch.Tensor) -> torch.Tensor:
    """G^{-1}(z) [B, D, D] for this rank's rows, with ``metric`` this rank's
    shard of the bank (:func:`shard_metric`).  The shard's sum is one
    ``g_inv`` call with lbd = 0 (the G^{-1} kernel on the card, its plain
    version on the CPU), differentiable in ``z`` as the dense ``g_inv`` is."""
    c, m, t = metric.centroids, metric.matrices, metric.temperature
    args = (z.float().contiguous(), c, m, 1.0 / (t * t), 0.0)
    gi = (GInv.apply(*args, metric.kernel_bank()) if fused_supported(metric.latent_dim)
          else plain_route(g_inv_ref, *args))
    gi = all_reduce_sum(gi.contiguous(), mesh, MODEL_AXIS)
    return gi + metric.regularization * _eye(gi.shape[-1], gi)


def chol_g_inv_sharded(mesh: Mesh, metric: CentroidMetric, z: torch.Tensor,
                       jitter: float = 1e-6) -> torch.Tensor:
    """L with L L^T = G^{-1}(z) + jitter I; the Cholesky runs after the
    all-reduce, on this rank's rows."""
    return _lin.cholesky_small(g_inv_sharded(mesh, metric, z), jitter=jitter)


def _finish_hmc_terms(gi_part: torch.Tensor, v: torch.Tensor, lbd: float):
    """The tail of the HMC terms after the all-reduce: + lbd I, Cholesky,
    guarded log target, G, and grad = -1/2 G^T v, all on this rank's rows."""
    gi = gi_part + lbd * _eye(gi_part.shape[-1], gi_part)
    l = _lin.cholesky_small(gi, jitter=0.0)
    half_ld = 0.5 * _lin.logdet_from_chol(l)
    logpi = torch.logaddexp(half_ld, half_ld.new_tensor(LOG_EPS))
    gz = _lin.inv_psd_small(gi, jitter=0.0)
    grad = -0.5 * torch.einsum("bji,bj->bi", gz, v)
    return logpi, grad


def hmc_terms_sharded(mesh: Mesh, metric: CentroidMetric,
                      z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log pi(z) [B], grad log pi(z) [B, D]) of the manifold-HMC target for
    this rank's rows, with ``metric`` this rank's shard of the bank: the
    pythae guarded target and closed-form gradient, as
    ``rlvae_tpu/parallel/metric_parallel.py:238``.  The two partial sums
    ride one all-reduce over the model group."""
    b, d = z.shape
    gi_part, v = _partial_terms(metric, z)
    buf = all_reduce_sum(torch.cat([gi_part.reshape(b, d * d), v], dim=1), mesh, MODEL_AXIS)
    return _finish_hmc_terms(buf[:, : d * d].reshape(b, d, d), buf[:, d * d:],
                             metric.regularization)


def sample_prior_hmc_sharded(
    mesh: Mesh,
    metric: CentroidMetric,
    num_samples: int,
    config: Optional[HMCConfig] = None,
    generator: Optional[torch.Generator] = None,
    z0: Optional[torch.Tensor] = None,
    gammas: Optional[torch.Tensor] = None,
    unifs: Optional[torch.Tensor] = None,
    return_diagnostics: bool = False,
):
    """Manifold-HMC prior chains, the rows over the data axis and the bank
    over the model axis (``rlvae_tpu/parallel/metric_parallel.py:265``).

    ``metric`` is the whole unpadded bank: the starts index its real
    centroids.  ``z0`` [N, D], ``gammas`` [S, N, D] and ``unifs`` [S, N] cover
    all ``num_samples`` rows; what is not given is drawn from ``generator``
    as :func:`~rlvae_tpu_torch.samplers.hmc.draw_hmc_noise` draws it, so
    every rank must pass a generator in the same state.  Each rank runs the
    dense sampler's integrator on its rows with the sharded terms (one
    all-reduce over the model group per evaluation); each step's accept
    rate is the local mean, summed over the data group and divided by its
    size (JAX's ``pmean``, the global mean since every rank has as many
    rows).  Returns z [N/dp, D] for this rank's rows, and with
    ``return_diagnostics`` also ``{"accept_rate", "log_pi"}``."""
    config = config or HMCConfig()
    if num_samples % mesh.dp != 0:
        raise ValueError(
            f"num_samples={num_samples} must divide the '{DATA_AXIS}' axis ({mesh.dp})")
    if z0 is None or gammas is None or unifs is None:
        drawn = draw_hmc_noise(metric, num_samples, config, generator)
        z0 = drawn["z0"] if z0 is None else z0
        gammas = drawn["gammas"] if gammas is None else gammas
        unifs = drawn["unifs"] if unifs is None else unifs
    dev = metric.centroids.device
    z0, gammas, unifs = (torch.as_tensor(t).to(device=dev, dtype=torch.float32)
                         for t in (z0, gammas, unifs))
    z0 = local_rows(mesh, z0)
    gammas, unifs = local_rows(mesh, gammas, 1), local_rows(mesh, unifs, 1)
    bank = shard_metric(mesh, metric)

    def terms(zz):
        return hmc_terms_sharded(mesh, bank, zz)

    def mean_fn(accept):
        return all_reduce_sum(accept.mean().reshape(1), mesh, DATA_AXIS)[0] / mesh.dp

    z, accept_rate, log_pi = run_prior_chain(terms, z0, gammas, unifs, config, mean_fn=mean_fn)
    if return_diagnostics:
        return z, {"accept_rate": accept_rate, "log_pi": log_pi}
    return z
