"""The metric kernels' autograd Functions against JAX's VJPs on the CPU.

``CholBundle``, ``CholBundleLogdet``, ``GInv``, ``MetricBundleG`` and the
pair ``MetricBundleGInvG`` differentiate in z, the centroids and the
matrices, as JAX's fused VJPs (``jax.vjp(..., metric, z)``) and its XLA
``g_inv`` do, and their VJPs are themselves differentiable: a second
derivative in z (a Hessian-vector product, and its derivative in the bank)
matches ``jax.grad`` of ``jax.grad``.  JAX's side: ``_chol_g_inv_xla``,
``logdet_from_chol`` of it, ``g_inv`` and ``_g_xla``, on a D=4, K=6 bank
(JAX's ``tests/test_geodesics.py`` ``curved_metric``), and for G^{-1} and
the factor L also on the shipped K=50 metric at T=3.0 (D=16).  The second
derivatives of G are those of the pair's G output.

Tolerances: first derivatives rtol 1e-4 with atol 1e-5 of each gradient's
largest entry (fp32, another summation order through the factorization and
the solves), as ``tests/test_torch_metric_bundle.py``; second derivatives
rtol 1e-4 with atol 1e-4 of the largest entry (one more order of rounding).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import metric as jgm
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.ops import linalg as jlin
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.ops.metric_kernels import (
    CholBundle,
    CholBundleLogdet,
    GInv,
    MetricBundleG,
    MetricBundleGInvG,
    metric_bundle,
)

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
B = 5
JITTER = 1e-6


def _curved():
    rng = np.random.default_rng(0)
    k, d = 6, 4
    a = rng.normal(size=(k, d, d)).astype(np.float32) * 0.5
    mats = a @ a.transpose(0, 2, 1) + 0.3 * np.eye(d, dtype=np.float32)
    cents = rng.normal(size=(k, d)).astype(np.float32) * 1.5
    return cents, mats, 1.2, 0.05


def _k50():
    m = load_metric(DATA / "metric_T0.7_scaled.npz", temperature_override=3.0)
    return m.centroids.numpy(), m.matrices.numpy(), m.temperature, m.regularization


BANKS = {"curved": _curved, "K50": _k50}


def _jax_fn(which, t, lbd):
    """f(c, m, z) of JAX's XLA path for the Function ``which``."""
    def metric(c, m):
        return JaxMetric(centroids=c, matrices=m, temperature=jnp.float32(t),
                         regularization=jnp.float32(lbd), latent_dim=c.shape[1])

    return {
        "chol": lambda c, m, z: jgm._chol_g_inv_xla(metric(c, m), z, jitter=JITTER),
        "logdet": lambda c, m, z: jlin.logdet_from_chol(jgm._chol_g_inv_xla(metric(c, m), z,
                                                                            jitter=0.0)),
        "g_inv": lambda c, m, z: jgm.g_inv(metric(c, m), z),
        "g": lambda c, m, z: jgm._g_xla(metric(c, m), z),
        "pair": lambda c, m, z: (jgm.g_inv(metric(c, m), z), jgm._g_xla(metric(c, m), z)),
    }[which]


def _torch_fn(which, t, lbd):
    inv_t2 = 1.0 / t ** 2
    return {
        "chol": lambda c, m, z: CholBundle.apply(z, c, m, inv_t2, lbd + JITTER),
        "logdet": lambda c, m, z: CholBundleLogdet.apply(z, c, m, inv_t2, lbd),
        "g_inv": lambda c, m, z: GInv.apply(z, c, m, inv_t2, lbd),
        "g": lambda c, m, z: MetricBundleG.apply(z, c, m, inv_t2, lbd),
        "pair": lambda c, m, z: MetricBundleGInvG.apply(z, c, m, inv_t2, lbd),
    }[which]


def _weights(out_shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in out_shapes]


def _case(bank, which):
    """(c, m, z, u, output weights, the JAX scalar loss f(c, m, z) and the
    port's) for one bank and Function."""
    c, m, t, lbd = BANKS[bank]()
    rng = np.random.default_rng(1)
    z = (c[rng.integers(0, c.shape[0], size=B)]
         + 0.3 * rng.normal(size=(B, c.shape[1]))).astype(np.float32)
    u = rng.normal(size=z.shape).astype(np.float32)
    d = c.shape[1]
    shapes = {"logdet": [(B,)], "pair": [(B, d, d), (B, d, d)]}.get(which, [(B, d, d)])
    ws = _weights(shapes, 2)
    jf, tf = _jax_fn(which, t, lbd), _torch_fn(which, t, lbd)

    def jloss(cc, mm, zz):
        out = jf(cc, mm, zz)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))

    def tloss(cc, mm, zz):
        out = tf(cc, mm, zz)
        outs = out if isinstance(out, tuple) else (out,)
        return sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws))

    return c, m, z, u, jloss, tloss


def _close(got, want, atol_frac):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol_frac * scale)


def _leaves(c, m, z):
    return [torch.tensor(a, requires_grad=True) for a in (c, m, z)]


@pytest.mark.parametrize("bank,which", [
    *(("curved", w) for w in ("chol", "logdet", "g_inv", "g", "pair")),
    # at D=16 JAX compiles its unrolled factorization's gradient for seconds
    # per function: G^{-1} (the weights) and the chol-bundle's factor
    ("K50", "g_inv"), ("K50", "chol"),
])
def test_gradients_in_z_and_the_bank_match_jax(bank, which):
    c, m, z, _, jloss, tloss = _case(bank, which)
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(c, m, z)
    leaves = _leaves(c, m, z)
    tloss(*leaves).backward()
    for name, leaf, w in zip(("centroids", "matrices", "z"), leaves, want):
        assert leaf.grad is not None, name
        _close(leaf.grad.numpy(), w, 1e-5)


@pytest.mark.parametrize("which", ["chol", "logdet", "g_inv", "pair"])
def test_second_derivatives_match_jax(which):
    """d/d(c, m, z) of u . df/dz: the VJP run under ``create_graph=True`` is
    differentiable (it was once-differentiable: this was silently zero)."""
    c, m, z, u, jloss, tloss = _case("curved", which)

    def jhvp(cc, mm, zz):
        return jnp.vdot(jax.grad(jloss, argnums=2)(cc, mm, zz), u)

    want = jax.jit(jax.grad(jhvp, argnums=(0, 1, 2)))(c, m, z)
    leaves = _leaves(c, m, z)
    (gz,) = torch.autograd.grad(tloss(*leaves), leaves[2], create_graph=True)
    (gz * torch.from_numpy(u)).sum().backward()
    for name, leaf, w in zip(("centroids", "matrices", "z"), leaves, want):
        assert leaf.grad is not None and bool(leaf.grad.abs().max() > 0), name
        _close(leaf.grad.numpy(), w, 1e-4)


def test_gradients_only_where_asked():
    """Inputs that need no grad get none, and a bank that requires no grad
    (the model's metric buffers) leaves the z-gradient as before."""
    c, m, z, _, _, tloss = _case("curved", "g")
    ct, mt = torch.from_numpy(c), torch.from_numpy(m)
    zt = torch.tensor(z, requires_grad=True)
    tloss(ct, mt, zt).backward()
    assert ct.grad is None and mt.grad is None
    leaves = _leaves(c, m, z)
    tloss(*leaves).backward()
    torch.testing.assert_close(zt.grad, leaves[2].grad, rtol=0, atol=0)


def test_pair_forward_is_the_bundles_g_inv_and_g():
    c, m, t, lbd = _curved()
    z = torch.from_numpy(c[:3] + 0.1)
    args = (torch.from_numpy(c), torch.from_numpy(m), 1.0 / t ** 2, lbd)
    gi, g = MetricBundleGInvG.apply(z, *args)
    want = metric_bundle(z, *args)
    assert torch.equal(gi, want[0]) and torch.equal(g, want[3])


def test_partials_when_z_is_computed_from_the_bank():
    """z = c + delta (as the RHVAE's z0 from the encoder's mu, which is also
    its batch's centroids): the Function's backward gives partials, so the
    total derivative in c is the sum of the two paths, as in JAX."""
    c, m, t, lbd = _curved()
    delta = np.random.default_rng(3).normal(size=c.shape).astype(np.float32) * 0.2
    w = np.random.default_rng(4).normal(size=(c.shape[0], 4, 4)).astype(np.float32)

    def jtotal(cc):
        metric = JaxMetric(centroids=cc, matrices=jnp.asarray(m), temperature=jnp.float32(t),
                           regularization=jnp.float32(lbd), latent_dim=4)
        return jnp.sum(jgm.g_inv(metric, cc + delta) * w)

    want = jax.jit(jax.grad(jtotal))(c)
    ct = torch.tensor(c, requires_grad=True)
    out = GInv.apply(ct + torch.from_numpy(delta), ct, torch.from_numpy(m), 1.0 / t ** 2, lbd)
    (out * torch.from_numpy(w)).sum().backward()
    _close(ct.grad.numpy(), want, 1e-5)
