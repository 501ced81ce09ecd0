"""Geodesics and curvature of the port against the JAX package on the CPU.

``rlvae_tpu_torch.geometry.geodesics`` and ``curvature`` against
``rlvae_tpu.geometry.geodesics`` and ``curvature``, on JAX's own fixtures of
``tests/test_geodesics.py`` (``curved_metric``: D=4, K=6; ``flat_metric``)
and on the shipped K=50 metric at T=3.0 (D=16, the default model's).  The
port batches rows where JAX vmaps single points; JAX's references are built
once, jitted.  Also the ``geodesic_exact`` prior on JAX's draws and
``ModelManager.interpolate(mode="geodesic")`` without a metric.

Tolerances, fixed here (fp32 on both sides; measured errors in brackets):
- ``dg_inv`` and ``christoffel``: rtol 1e-5, atol 1e-5 of the largest entry
  [4e-7 of it].
- ``exp_map`` endpoint and path: rtol 1e-5, atol 1e-5 of max(1, |z|) [1e-7].
- one ``energy_path`` Adam step from JAX's own carry (step 101 of 150):
  on JAX's gradient the interior and both moments at rtol 1e-6, atol 1e-7
  of their scale; the port's gradient within atol 1e-4 of JAX's; the
  step on it at rtol 1e-6, atol 1e-7 of max(1, |x|).
- whole ``energy_path`` (150 Adam steps): positions within
  PATH_ATOL of max(1, |z|) and the energy within rtol ENERGY_RTOL.  Near
  convergence Adam's m / sqrt(v) turns last-bit gradient differences into
  lr-sized steps, so whole paths are held by these measured tolerances and
  the single step above by the tight one.
- ``path_length``: rtol 1e-5.
- ``log_map`` (both inits) and ``geodesic_interpolate(method="shooting")``:
  within 1e-4 of max(1, |v|) [3e-7]: Gauss-Newton converges to the same
  fixed point, and its keep-if-better test compares residuals far apart
  from rounding here (no tie within 1e-5 relative, counted).
- ``gaussian_curvature_2d``: rtol 1e-3, atol 1e-3 of the largest |K|.
- ``geodesic_exact`` latents: within PATH_ATOL of max(1, |z|), but for
  rows whose centroid pair is one centroid (see the test).

The K=50 metric's whole energy paths are held to JAX in
``tests/test_torch_generate.py`` (``geodesic_exact``) and
``tests/test_torch_inference_extras.py`` (``interpolate``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlvae_tpu.geometry import curvature as jcurv
from rlvae_tpu.geometry import geodesics as jgeo
from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.samplers import riemannian as jsr
from rlvae_tpu_torch import ModelManager
from rlvae_tpu_torch.geometry import curvature as tcurv
from rlvae_tpu_torch.geometry import geodesics as tgeo
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.models import RlVAE
from rlvae_tpu_torch.ops.metric_kernels import g_inv, metric_bundle
from rlvae_tpu_torch.samplers import sample_prior

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
D = 4
PATH_ATOL = 1e-4
ENERGY_RTOL = 1e-5


def _curved_arrays():
    rng = np.random.default_rng(0)
    k = 6
    a = rng.normal(size=(k, D, D)).astype(np.float32) * 0.5
    mats = a @ a.transpose(0, 2, 1) + 0.3 * np.eye(D, dtype=np.float32)
    cents = rng.normal(size=(k, D)).astype(np.float32) * 1.5
    return cents, mats


@pytest.fixture(scope="module")
def metrics():
    """name -> (JAX metric, port metric)."""
    c, m = _curved_arrays()
    name = DATA / "metric_T0.7_scaled.npz"
    return {
        "curved": (JaxMetric.create(c, m, temperature=1.2, regularization=0.05),
                   CentroidMetric.create(c, m, temperature=1.2, regularization=0.05)),
        "flat": (JaxMetric.identity(D, n_centroids=3, temperature=1e4),
                 CentroidMetric.identity(D, n_centroids=3, temperature=1e4)),
        "K50": (jax_load_metric(name, temperature_override=3.0),
                load_metric(name, temperature_override=3.0)),
    }


def _rows(metric, n, seed, scale=0.3):
    c = np.asarray(metric.centroids)
    rng = np.random.default_rng(seed)
    return (c[rng.integers(0, c.shape[0], size=n)]
            + scale * rng.normal(size=(n, c.shape[1]))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a), np.float32))


def _close_scaled(got, want, atol, rtol=0.0, floor=1.0):
    want = np.asarray(want)
    scale = max(floor, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("name", ["curved", "K50"])
def test_dg_inv_and_christoffel_match_jax(metrics, name):
    jm, tm = metrics[name]
    z = _rows(jm, 3, 1)
    want_dgi, want_gam = jax.jit(jax.vmap(
        lambda zz: (jgeo.dg_inv(jm, zz), jgeo.christoffel(jm, zz))))(jnp.asarray(z))
    got_gam = tgeo.christoffel(tm, _t(z)).numpy()
    _close_scaled(tgeo.dg_inv(tm, _t(z)).numpy(), want_dgi, 1e-5, rtol=1e-5, floor=0.0)
    _close_scaled(got_gam, want_gam, 1e-5, rtol=1e-5, floor=0.0)
    np.testing.assert_allclose(got_gam, got_gam.transpose(0, 1, 3, 2), rtol=1e-5, atol=1e-6)
    # a single point [D] gives [D, D, D], as JAX
    assert tgeo.christoffel(tm, _t(z[0])).shape == (z.shape[1],) * 3


def test_flat_metric_is_flat(metrics):
    _, tm = metrics["flat"]
    rng = np.random.default_rng(3)
    z0, v = _t(rng.normal(size=(D,))), _t(rng.normal(size=(D,)))
    assert float(tgeo.christoffel(tm, z0).abs().max()) < 1e-6
    end, path = tgeo.exp_map(tm, z0, v, n_steps=8, return_path=True)
    torch.testing.assert_close(end, z0 + v, rtol=1e-5, atol=1e-5)
    assert path.shape == (9, D)
    torch.testing.assert_close(path[4], z0 + 0.5 * v, rtol=1e-4, atol=1e-4)


def test_exp_map_matches_jax(metrics):
    """Endpoint and path of 3 rows, one metric-bundle call per RK4 stage."""
    jm, tm = metrics["curved"]
    z0 = _rows(jm, 3, 4)
    v = (_rows(jm, 3, 5) - z0) * 0.5
    want_end, want_path = jax.jit(jax.vmap(lambda a, b: jgeo.exp_map(
        jm, a, b, n_steps=8, return_path=True)))(jnp.asarray(z0), jnp.asarray(v))
    calls = metric_bundle.launches
    end, path = tgeo.exp_map(tm, _t(z0), _t(v), n_steps=8, return_path=True)
    assert metric_bundle.launches == calls  # CPU tensors: the plain version
    assert path.shape == (3, 9, z0.shape[1])
    _close_scaled(end.numpy(), want_end, 1e-5, rtol=1e-5)
    _close_scaled(path.numpy(), want_path, 1e-5, rtol=1e-5)


def _jax_adam_carry(jm, z0, z1, n_points, k, lr=0.05):
    """JAX's energy_path carry (interior, Adam state) after k steps, JAX's
    gradient there, and the carry after step k + 1, by JAX's own step
    (``_segment_energy``, ``optax.adam``)."""
    ts = jnp.linspace(0.0, 1.0, n_points)[1:-1, None]
    x0 = (1.0 - ts) * z0[None] + ts * z1[None]
    assemble = lambda it: jnp.concatenate([z0[None], it, z1[None]], axis=0)  # noqa: E731
    loss = lambda it: jgeo._segment_energy(jm, assemble(it))  # noqa: E731
    opt = optax.adam(lr)

    def step(carry, _):
        it, st = carry
        up, st = opt.update(jax.grad(loss)(it), st, it)
        return (optax.apply_updates(it, up), st), None

    carry, _ = jax.lax.scan(step, (x0, opt.init(x0)), None, length=k)
    return carry, jax.grad(loss)(carry[0]), step(carry, None)[0]


def test_energy_path_one_step_from_jax_carry(metrics):
    """Step 101 of 150 from JAX's own carry.  Given JAX's gradient the
    optax-form Adam step reproduces JAX's interior and moments to an ulp;
    the port's gradient (one metric-bundle call and its recompute VJP) is
    held to JAX's within 1e-6 of the energy gradient's terms (a term of
    2 (P-1) G d reaches ~1e2 here, and fp32 rounds it at ~1e-5; the
    gradient itself is ~1e-2 near convergence), and the step taken with it
    to JAX's within rtol 1e-6, atol 1e-7 of max(1, |x|)."""
    jm, tm = metrics["curved"]
    c = np.asarray(jm.centroids)
    z0, z1, k = c[0], c[2], 100
    (x, st), jgrad, (x1, st1) = jax.jit(lambda a, b: _jax_adam_carry(jm, a, b, 12, k))(
        jnp.asarray(z0), jnp.asarray(z1))
    adam, adam1 = st[0], st1[0]
    assert int(adam.count) == k
    a, b, xt = _t(z0)[None], _t(z1)[None], _t(x)[None]
    mu0, nu0 = _t(adam.mu)[None], _t(adam.nu)[None]
    got, mu, nu = tgeo.adam_update(xt, _t(jgrad)[None], mu0, nu0, k + 1, 0.05)
    for mine, want in ((got, x1), (mu, adam1.mu), (nu, adam1.nu)):
        _close_scaled(mine[0].numpy(), want, 1e-7, rtol=1e-6, floor=0.0)
    grad = tgeo.energy_grad(tm, a, b, xt)
    np.testing.assert_allclose(grad[0].numpy(), np.asarray(jgrad), rtol=0, atol=1e-4)
    got, _, _ = tgeo.adam_update(xt, grad, mu0, nu0, k + 1, 0.05)
    _close_scaled(got[0].numpy(), x1, 1e-7, rtol=1e-6)


def test_energy_path_matches_jax(metrics):
    """Whole paths of 3 centroid pairs (JAX vmaps them), their energy and
    length; the energy path is shorter than the straight line."""
    jm, tm = metrics["curved"]
    c = np.asarray(jm.centroids)
    z0, z1 = c[[0, 1, 3]], c[[2, 4, 5]]
    want = jax.jit(jax.vmap(lambda a, b: jgeo.energy_path(jm, a, b, n_points=12, n_iters=150)))(
        jnp.asarray(z0), jnp.asarray(z1))
    got = tgeo.energy_path(tm, _t(z0), _t(z1), n_points=12, n_iters=150)
    assert got.shape == (3, 12, c.shape[1])
    np.testing.assert_array_equal(got[:, 0].numpy(), z0)
    np.testing.assert_array_equal(got[:, -1].numpy(), z1)
    _close_scaled(got.numpy(), want, PATH_ATOL)
    want_e = np.asarray(jax.vmap(lambda p: jgeo._segment_energy(jm, p))(want))
    np.testing.assert_allclose(tgeo._segment_energy(tm, got).numpy(), want_e, rtol=ENERGY_RTOL)
    lin = tgeo.geodesic_interpolate(tm, _t(z0), _t(z1), n_points=12, method="linear")
    assert bool((tgeo.path_length(tm, got) < tgeo.path_length(tm, lin)).all())


def test_path_length_matches_jax(metrics):
    jm, tm = metrics["curved"]
    paths = np.stack([_rows(jm, 6, s, scale=0.5) for s in range(3)])  # [3, 6, D]
    want = jax.jit(jax.vmap(lambda p: jgeo.path_length(jm, p)))(jnp.asarray(paths))
    got = tgeo.path_length(tm, _t(paths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(float(tgeo.path_length(tm, _t(paths[1]))), float(want[1]),
                               rtol=1e-5)


def _log_pair(jm):
    c = np.asarray(jm.centroids)
    rng = np.random.default_rng(4)
    return c[0], (c[1] + 0.1 * rng.normal(size=(D,))).astype(np.float32)


SHOOT = {"n_steps": 8, "n_iters": 8}  # RK4 steps and Gauss-Newton iterations


@pytest.fixture(scope="module")
def jax_shooting(metrics):
    """JAX's log_map of one pair from both inits, in one jitted program (the
    jacfwd through the integrator compiles for seconds)."""
    jm, _ = metrics["curved"]
    z0, z1 = _log_pair(jm)

    def run(a, b):
        return {"energy": jgeo.log_map(jm, a, b, init="energy", **SHOOT),
                "linear": jgeo.log_map(jm, a, b, init="linear", **SHOOT)}

    return z0, z1, _numpy_tree(jax.jit(run)(jnp.asarray(z0), jnp.asarray(z1)))


def _numpy_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("init", ["energy", "linear"])
def test_log_map_matches_jax(metrics, jax_shooting, init):
    """JAX's own case (tests/test_geodesics.py) at 8 RK4 steps and 8
    Gauss-Newton iterations: the shooting velocity, and the residual of
    shooting with it, against JAX's; the port runs the pair in a batch with
    its reverse (rows are independent)."""
    jm, tm = metrics["curved"]
    z0, z1, want = jax_shooting
    want = want[init]
    got = tgeo.log_map(tm, _t(np.stack([z0, z1])), _t(np.stack([z1, z0])), init=init, **SHOOT)
    assert got.shape == (2, D) and bool(torch.isfinite(got).all())
    _close_scaled(got[0].numpy(), want, 1e-4)
    resid = np.linalg.norm(tgeo.exp_map(tm, _t(z0), got[0], n_steps=8).numpy() - z1)
    want_resid = np.linalg.norm(np.asarray(jgeo.exp_map(jm, jnp.asarray(z0), want, n_steps=8))
                                - z1)
    np.testing.assert_allclose(resid, want_resid, rtol=1e-2, atol=1e-6)
    assert resid < 1e-3  # JAX's own case converges


@pytest.mark.parametrize("method", ["linear", "energy", "shooting"])
def test_geodesic_interpolate_matches_jax(metrics, jax_shooting, monkeypatch, method):
    """``shooting`` runs JAX's geodesic_interpolate with its log_map
    returning JAX's own velocity of the fixture (held to the port's in
    test_log_map_matches_jax), so only the replay compiles here."""
    jm, tm = metrics["curved"]
    z0, z1, shooting = jax_shooting
    kwargs = {"shooting": SHOOT, "energy": {"n_iters": 100}}.get(method, {})
    if method == "shooting":
        def log_map(metric, a, b, **kw):
            assert kw == SHOOT
            return jnp.asarray(shooting["energy"])

        monkeypatch.setattr(jgeo, "log_map", log_map)
    want = jax.jit(lambda a, b: jgeo.geodesic_interpolate(
        jm, a, b, n_points=9, method=method, **kwargs))(jnp.asarray(z0), jnp.asarray(z1))
    got = tgeo.geodesic_interpolate(tm, _t(z0), _t(z1), n_points=9, method=method, **kwargs)
    assert got.shape == (9, D)
    _close_scaled(got.numpy(), want, 1e-4 if method == "shooting" else PATH_ATOL)
    with pytest.raises(ValueError, match="unknown geodesic method"):
        tgeo.geodesic_interpolate(tm, _t(z0), _t(z1), method="warp")


def test_gaussian_curvature_matches_jax(metrics):
    jm, tm = metrics["curved"]
    c = np.asarray(jm.centroids)
    rng = np.random.default_rng(5)
    basis = np.linalg.qr(rng.normal(size=(D, 2)))[0].astype(np.float32)
    origin = c.mean(0)
    pts = rng.normal(size=(6, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: jcurv.gaussian_curvature_2d(
        jm, jnp.asarray(basis), jnp.asarray(origin), p))(jnp.asarray(pts)))
    got = tcurv.gaussian_curvature_2d(tm, _t(basis), _t(origin), _t(pts)).numpy()
    _close_scaled(got, want, 1e-3, rtol=1e-3, floor=0.0)
    g_tilde = tcurv.induced_metric_2d(tm, _t(basis), _t(origin))(_t(pts[0]))
    assert g_tilde.shape == (2, 2)


def test_geodesic_exact_matches_jax(metrics):
    """The prior on JAX's draws (i1, i2, s, eps from its four keys): a point
    on the energy path between the centroid pair plus metric noise."""
    jm, tm = metrics["curved"]
    key, n = jax.random.PRNGKey(7), 5
    want = np.asarray(jsr.sample_prior(jm, key, n, D, "geodesic_exact"))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    noise = {"i1": jax.random.randint(k1, (n,), 0, jm.n_centroids),
             "i2": jax.random.randint(k2, (n,), 0, jm.n_centroids),
             "s": jax.random.uniform(k3, (n,)), "eps": jax.random.normal(k4, (n, D))}
    noise = {k: torch.tensor(np.asarray(v)) for k, v in noise.items()}
    launches = g_inv.launches
    got = sample_prior(tm, n, D, "geodesic_exact", noise=noise).numpy()
    assert g_inv.launches == launches
    # where i1 == i2 the path has zero length: its interior starts at the
    # centroid to rounding, Adam turns that rounding into lr-sized steps, and
    # the unit tangent (and so the noise's direction) is rounding noise, in
    # JAX as here.  Such rows are held to lie within the noise's reach of
    # their centroid; the others to JAX's.
    same = (noise["i1"] == noise["i2"]).numpy()
    assert same.sum() == 1  # this key's draws hold one such row
    _close_scaled(got[~same], want[~same], PATH_ATOL)
    c = np.asarray(jm.centroids)[noise["i1"].numpy()[same]]
    reach = 0.2 * float(np.linalg.norm(noise["eps"].numpy()[same])) * float(
        np.sqrt(np.linalg.eigvalsh(tm.g_inv(_t(c)).numpy()).max())) + 0.1
    assert np.abs(got[same] - c).max() <= reach and np.abs(want[same] - c).max() <= reach
    drawn = sample_prior(tm, 3, D, "geodesic_exact", generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, D) and bool(torch.isfinite(drawn).all())


def test_interpolate_geodesic_without_a_metric_raises():
    model = RlVAE(input_dim=(3, 8, 8), latent_dim=8, n_flows=0, posterior_type="gaussian",
                  encoder_config={"architecture": "mlp", "hidden_dims": [16]},
                  decoder_config={"architecture": "mlp", "hidden_dims": [16]})
    x = np.random.default_rng(6).uniform(size=(3, 8, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="metric"):
        ModelManager(model, device="cpu").interpolate(x, x, n_steps=3, mode="geodesic")


def test_metric_views_and_identity():
    """The method views of CentroidMetric, and ``identity``."""
    c, m = _curved_arrays()
    tm = CentroidMetric.create(c, m, temperature=1.2, regularization=0.05)
    z = _t(c[:3] + 0.1)
    from rlvae_tpu_torch.geometry import metric as tgm

    assert tm.latent_dim == D
    for name in ("weights", "g_inv", "g", "chol_g_inv", "logdet_g", "log_sqrt_det_g_inv",
                 "grad_log_sqrt_det_g_inv"):
        assert torch.equal(getattr(tm, name)(z), getattr(tgm, name)(tm, z)), name
    assert torch.equal(tm.dist2(z, z + 0.1), tgm.dist2(tm, z, z + 0.1))
    assert tm.diagnostics(z) == tgm.diagnostics(tm, z)
    ident = CentroidMetric.identity(D, n_centroids=2, generator=torch.Generator().manual_seed(0))
    assert ident.centroids.shape == (2, D) and bool((ident.centroids != 0).any())
    assert torch.equal(ident.matrices, torch.eye(D).expand(2, D, D))
    assert torch.equal(CentroidMetric.identity(D).centroids, torch.zeros(1, D))
