"""The port's HMC terms, the metric's G and target, and the manifold-HMC
prior chain against the JAX package, on the same numpy inputs and JAX's own
chain noise (``draw_chain_noise``), on the CPU.

Tolerances, each with its reason:
- linalg solves and inverse: rtol 1e-5 (fp32, the same column/row order);
  G, within 1e-4 of its largest entry (the inverse of a matrix whose
  smallest eigenvalue is ~lbd amplifies G^{-1}'s rounding by its condition
  number).
- log pi: atol 1e-5 (a sum of 16 logs of fp32 Cholesky pivots).  The pythae
  grad: within 1e-4 of its largest |entry| (it goes through G).
- One MCMC step (15 leapfrog steps) from JAX's state: z within 1e-4 of
  max(1, |z|); the accept decision identical unless |u - alpha| < 1e-3
  (the fp32 terms differ in the last bits, and alpha is exp of their sums).
- Whole chains: see ``test_full_chain_matches_jax``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.geometry import metric as jgm
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.ops import linalg as jlin
from rlvae_tpu.ops.metric_kernels import hmc_terms_pallas
from rlvae_tpu.samplers import hmc as jhmc
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.geometry import metric as tgm
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.ops import linalg as tlin
from rlvae_tpu_torch.ops.metric_kernels import chol_bundle, hmc_terms, hmc_terms_ref
from rlvae_tpu_torch.samplers import hmc as thmc

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
LOG_EPS = float(np.log(np.float32(1e-10)))
LP_ATOL = 1e-5
GRAD_REL = 1e-4
STEP_REL = 1e-4
ALPHA_MARGIN = 1e-3


def _pair(name="metric_T0.7_scaled.npz", t_override=3.0):
    return (jax_load_metric(DATA / name, temperature_override=t_override),
            load_metric(DATA / name, temperature_override=t_override))


def _latents(centroids, b, scale, seed, n_far=0):
    rng = np.random.default_rng(seed)
    c = np.asarray(centroids)
    z = c[rng.integers(0, c.shape[0], size=b)] + scale * rng.normal(size=(b, c.shape[1]))
    z[b - n_far:] += 50.0  # far from every centroid: w underflows, log pi on the plateau
    return z.astype(np.float32)


def _ref(tm, z):
    return hmc_terms_ref(torch.from_numpy(z), tm.centroids, tm.matrices,
                         1.0 / tm.temperature ** 2, tm.regularization, LOG_EPS)


def _assert_terms(got, want_lp, want_grad):
    lp, grad = (t.numpy() for t in got)
    want_lp, want_grad = np.asarray(want_lp), np.asarray(want_grad)
    np.testing.assert_allclose(lp, want_lp, rtol=0, atol=LP_ATOL)
    scale = max(float(np.abs(want_grad).max()), 1e-30)
    np.testing.assert_array_less(np.abs(grad - want_grad), GRAD_REL * scale + 1e-30)


# ---------------------------------------------------------------------------
# linalg and the metric's plain terms
# ---------------------------------------------------------------------------


def _spd(rng, b, d=16):
    a = rng.normal(size=(b, d, d)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / d + 0.5 * np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
def test_solve_and_inv_psd_small(jitter):
    rng = np.random.default_rng(0)
    a = _spd(rng, 6)
    b = rng.normal(size=(6, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tlin.solve_psd_small(torch.from_numpy(a), torch.from_numpy(b), jitter=jitter).numpy(),
        np.asarray(jlin.solve_psd_small(jnp.asarray(a), jnp.asarray(b), jitter=jitter)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tlin.inv_psd_small(torch.from_numpy(a), jitter=jitter).numpy(),
        np.asarray(jlin.inv_psd_small(jnp.asarray(a), jitter=jitter)), rtol=1e-5, atol=1e-6)


METRICS = [("metric_T0.7_scaled.npz", 3.0), ("metric.npz", None)]


@pytest.mark.parametrize("name,t_override", METRICS)
def test_metric_g_and_hmc_target(name, t_override):
    jm, tm = _pair(name, t_override)
    z = _latents(jm.centroids, 9, 0.05, 1, n_far=2)
    zj, zt = jnp.asarray(z), torch.from_numpy(z)
    want_g = np.asarray(jgm.g(jm, zj))
    got_g = tgm.g(tm, zt).numpy()
    np.testing.assert_array_less(np.abs(got_g - want_g), 1e-4 * np.abs(want_g).max())
    _assert_terms((tgm.log_sqrt_det_g_inv(tm, zt), tgm.grad_log_sqrt_det_g_inv(tm, zt)),
                  jgm.log_sqrt_det_g_inv(jm, zj), jgm.grad_log_sqrt_det_g_inv(jm, zj))
    np.testing.assert_allclose(tgm.log_sqrt_det_g_inv(tm, zt, eps=0.0).numpy(),
                               np.asarray(jgm.log_sqrt_det_g_inv(jm, zj, eps=0.0)),
                               rtol=0, atol=LP_ATOL)


@pytest.mark.parametrize("name,t_override", METRICS)
def test_grad_log_sqrt_det_g_inv_is_the_terms_gradient(name, t_override, monkeypatch):
    """``grad_log_sqrt_det_g_inv`` is the gradient output of the ``hmc_terms``
    wrapper (the B4 kernel on the card): one call, bit for bit its output on
    the CPU, and JAX's closed form within the terms' tolerance."""
    from rlvae_tpu_torch.ops import metric_kernels as mk

    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return hmc_terms(*args)

    monkeypatch.setattr(mk, "hmc_terms", counting)
    jm, tm = _pair(name, t_override)
    z = _latents(jm.centroids, 9, 0.05, 5, n_far=2)
    zt = torch.from_numpy(z)
    got = tgm.grad_log_sqrt_det_g_inv(tm, zt)
    assert calls == [(9, 16)]
    want = hmc_terms(zt, tm.centroids, tm.matrices, 1.0 / tm.temperature ** 2,
                     tm.regularization, LOG_EPS)[1]
    assert torch.equal(got, want)
    want_j = np.asarray(jgm.grad_log_sqrt_det_g_inv(jm, jnp.asarray(z)))
    scale = max(float(np.abs(want_j).max()), 1e-30)
    np.testing.assert_array_less(np.abs(got.numpy() - want_j), GRAD_REL * scale + 1e-30)


# ---------------------------------------------------------------------------
# hmc_terms_ref against the Pallas kernel and the XLA terms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,t_override,b", [("metric_T0.7_scaled.npz", 3.0, 37),
                                               ("metric.npz", None, 5)])
def test_hmc_terms_ref_vs_pallas_interpret(name, t_override, b):
    """K=50 and K=200, ragged batches with far points, against the Pallas
    kernel itself (interpret mode)."""
    jm, tm = _pair(name, t_override)
    z = _latents(jm.centroids, b, 0.05, 2, n_far=2)
    lp, grad = hmc_terms_pallas(jm, jnp.asarray(z), interpret=True)
    got = _ref(tm, z)
    _assert_terms(got, lp, grad)
    # the far rows: every weight underflows, log pi sits on the log 1e-10 plateau
    np.testing.assert_allclose(got[0][-2:].numpy(), LOG_EPS, rtol=0, atol=LP_ATOL)
    assert torch.all(got[1][-2:] == 0)


def test_hmc_terms_ref_large_bank_vs_xla():
    """K=20 000 (the K-chunked regime on the TPU), against the XLA terms."""
    rng = np.random.default_rng(3)
    k, d = 20_000, 16
    c = rng.normal(size=(k, d)).astype(np.float32)
    a = rng.normal(size=(k, d, d)).astype(np.float32) / np.sqrt(d)
    m = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)
    jm = JaxMetric.create(c, m, temperature=0.5, regularization=0.01)
    tm = CentroidMetric.create(c, m, temperature=0.5, regularization=0.01)
    z = _latents(c, 4, 0.1, 4)
    zj = jnp.asarray(z)
    _assert_terms(_ref(tm, z), jgm.log_sqrt_det_g_inv(jm, zj), jgm.grad_log_sqrt_det_g_inv(jm, zj))


def test_hmc_terms_cpu_route():
    """On CPU tensors the wrapper is the plain version and launches nothing."""
    _, tm = _pair()
    z = torch.from_numpy(_latents(tm.centroids.numpy(), 4, 0.1, 5))
    args = (tm.centroids, tm.matrices, 1.0 / 9.0, tm.regularization, LOG_EPS)
    before = hmc_terms.launches
    got, want = hmc_terms(z, *args), hmc_terms_ref(z, *args)
    assert hmc_terms.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="unsupported device"):
        hmc_terms(torch.empty((4, 16), device="meta"), *args)


# ---------------------------------------------------------------------------
# C2: logdet G^{-1} is differentiable (one chol-bundle launch on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,t_override", METRICS)
def test_logdet_g_inv_gradient_matches_jax(name, t_override):
    jm, tm = _pair(name, t_override)
    z = _latents(jm.centroids, 7, 0.05, 6)
    w = np.random.default_rng(7).normal(size=7).astype(np.float32)
    want = np.asarray(jax.grad(lambda zz: jnp.sum(jgm.logdet_g_inv(jm, zz) * w))(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    ld = tgm.logdet_g_inv(tm, zt)
    assert ld.requires_grad
    np.testing.assert_array_equal(  # the forward is the bundle's logdet output
        ld.detach().numpy(), chol_bundle(zt.detach(), tm.centroids, tm.matrices,
                                         1.0 / tm.temperature ** 2, tm.regularization)[1].numpy())
    (ld * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beta_zero", [1.0, 0.3, 4.0])
def test_tempering_matches_jax(beta_zero):
    b0s = np.sqrt(np.float32(beta_zero))
    for k in range(16):
        want = np.asarray(jhmc.tempering(jnp.float32(k), 15, jnp.sqrt(jnp.float32(beta_zero))))
        assert thmc.tempering(float(k), 15, b0s) == want


def _jax_chain(jm, z0, gammas, unifs, config):
    terms = jhmc._terms_fn(jm, "xla")
    z, rate, lp, zs = jhmc.run_prior_chain(terms, jnp.asarray(z0), gammas, unifs, config,
                                           collect_states=True)
    return (np.asarray(z), float(rate), np.asarray(lp), np.asarray(zs))


def _jax_noise(init, b, steps, seed, jm):
    """The draws of JAX's sample_prior_hmc for key PRNGKey(seed)."""
    k_init, k_chain = jax.random.split(jax.random.PRNGKey(seed))
    if init == "centroids":
        z0 = np.asarray(jm.centroids)[np.asarray(
            jax.random.randint(k_init, (b,), 0, jm.n_centroids))]
    else:
        z0 = np.asarray(jax.random.normal(k_init, (b, 16)))
    gammas, unifs = jhmc.draw_chain_noise(k_chain, steps, b, 16)
    return z0, gammas, unifs


def _state(tm, z):
    zt = torch.tensor(np.asarray(z))
    lp, grad = thmc._terms_fn(tm)(zt)
    return (zt, lp, -grad, np.float32(1.0))


@pytest.fixture(scope="module")
def jax_chains():
    """JAX's default chain (100 x 15) at B=8 on the K=50 metric, for both
    inits, from the draws of sample_prior_hmc: {init: (z0, gammas, unifs,
    (z, accept_rate, log_pi, zs))}."""
    jm, _ = _pair()
    out = {}
    for init, seed in (("centroids", 21), ("randn", 11)):
        z0, gammas, unifs = _jax_noise(init, 8, 100, seed, jm)
        out[init] = (z0, gammas, unifs,
                     _jax_chain(jm, z0, gammas, unifs, jhmc.HMCConfig(init=init, backend="xla")))
    return out


@pytest.mark.parametrize("init", ["centroids", "randn"])
def test_mcmc_step_matches_jax_per_step(jax_chains, init):
    """Each of the first 12 MCMC steps of the port, from JAX's state after
    the step before, with JAX's momenta and uniforms, against JAX's next
    state."""
    _, tm = _pair()
    steps = 12
    z0, gammas, unifs, (_, _, _, zs) = jax_chains[init]
    tcfg = thmc.HMCConfig(init=init)
    gam, uni = torch.tensor(np.asarray(gammas)), torch.tensor(np.asarray(unifs))
    prev, n_accept, n_ties = z0, 0, 0
    for s in range(steps):
        state, accept, alpha = thmc.mcmc_step(thmc._terms_fn(tm), _state(tm, prev), gam[s],
                                              uni[s], tcfg)
        jax_accept = np.any(zs[s] != prev, axis=1)
        tie = np.abs(uni[s].numpy() - alpha.numpy()) < ALPHA_MARGIN
        n_ties += int(tie.sum())
        np.testing.assert_array_equal(accept.numpy()[~tie], jax_accept[~tie])
        same = accept.numpy() == jax_accept
        got = state[0].numpy()
        np.testing.assert_array_less(np.abs(got - zs[s])[same],
                                     (STEP_REL * np.maximum(1.0, np.abs(zs[s])))[same])
        n_accept += int(jax_accept.sum())
        prev = zs[s]
    assert n_accept > 0 and n_ties <= 2, (n_accept, n_ties)


def test_chain_tempering_ratio_matches_jax():
    """beta_zero = 4: the tempering ratio, beta_sqrt_old / beta_sqrt, starts
    at sqrt(b0) and is carried across MCMC steps."""
    jm, tm = _pair()
    steps, b = 2, 6
    z0, gammas, unifs = _jax_noise("randn", b, steps, 5, jm)
    jcfg = jhmc.HMCConfig(mcmc_steps=steps, n_lf=3, beta_zero=4.0, init="randn", backend="xla")
    tcfg = thmc.HMCConfig(mcmc_steps=steps, n_lf=3, beta_zero=4.0, init="randn")
    jz, _, _, jzs = _jax_chain(jm, z0, gammas, unifs, jcfg)
    tz, _, _, tzs = thmc.run_prior_chain(
        thmc._terms_fn(tm), torch.tensor(z0), torch.tensor(np.asarray(gammas)),
        torch.tensor(np.asarray(unifs)), tcfg, collect_states=True)
    np.testing.assert_allclose(tzs.numpy(), jzs, rtol=STEP_REL, atol=STEP_REL)


def test_accept_rule_nan_and_guard_match_jax():
    """A target whose exp(-h0) overflows or underflows on some rows: the
    official form's 0/0 and inf/inf give NaN and reject; the guarded form
    clamps.  Same decisions as JAX's chain evaluated as written, row by row,
    for both inits.  JAX runs eagerly here (``disable_jit``): compiled, XLA's
    simplifier rewrites exp(-h)/exp(-h0) into exp(h0-h), which differs from
    the source exactly on these rows (ROADMAP.md queue C)."""
    # log pi offsets: exp(-h0) is 0 or inf on the outer rows, normal inside.
    # Offsets that put exp(-h0) among the fp32 subnormals are left out: XLA on
    # the CPU flushes them to zero, PyTorch keeps them.
    offsets = np.array([-250, -200, -10, -5, 0, 5, 200, 250], np.float32)

    def jax_terms(z):
        return (jnp.asarray(offsets) - 0.5 * jnp.sum(z * z, axis=1), -z)

    def torch_terms(z):
        return (torch.from_numpy(offsets) - 0.5 * (z * z).sum(1), -z)

    rng = np.random.default_rng(8)
    z0 = rng.normal(size=(8, 16)).astype(np.float32)
    gammas = rng.normal(size=(2, 8, 16)).astype(np.float32)
    unifs = rng.uniform(size=(2, 8)).astype(np.float32)
    for init in ("centroids", "randn"):
        jcfg = jhmc.HMCConfig(mcmc_steps=2, n_lf=3, init=init, backend="xla")
        tcfg = thmc.HMCConfig(mcmc_steps=2, n_lf=3, init=init)
        with jax.disable_jit():
            _, _, _, jzs = jhmc.run_prior_chain(jax_terms, jnp.asarray(z0), jnp.asarray(gammas),
                                                jnp.asarray(unifs), jcfg, collect_states=True)
        _, _, _, tzs = thmc.run_prior_chain(torch_terms, torch.from_numpy(z0),
                                            torch.from_numpy(gammas), torch.from_numpy(unifs),
                                            tcfg, collect_states=True)
        jzs = np.asarray(jzs)
        moved_j = np.any(jzs != np.concatenate([z0[None], jzs[:-1]]), axis=2)
        moved_t = np.any(tzs.numpy() != np.concatenate([z0[None], tzs.numpy()[:-1]]), axis=2)
        np.testing.assert_array_equal(moved_t, moved_j, err_msg=init)
        np.testing.assert_allclose(tzs.numpy(), jzs, rtol=1e-6, atol=1e-6)
    state = (torch.from_numpy(z0), *torch_terms(torch.from_numpy(z0)), np.float32(1.0))
    state = (state[0], state[1], -state[2], state[3])
    _, accept, alpha = thmc.mcmc_step(torch_terms, state, torch.from_numpy(gammas[0]),
                                      torch.from_numpy(unifs[0]), thmc.HMCConfig(n_lf=4))
    assert torch.isnan(alpha).any() and not accept[torch.isnan(alpha)].any()


def test_full_chain_matches_jax(jax_chains):
    """The default chain (100 x 15, eps 0.03) at B=8 on the K=50 metric, JAX's
    starts and noise, end to end: 1601 terms calls.  fp32 chains can drift
    apart, and a flipped accept would separate a row for good; the test
    allows one such row and holds the others to 1e-5 of max(1, |z|)
    (measured: no flip, 3.6e-7; ROADMAP.md queue C)."""
    _, tm = _pair()
    b = 8
    z0, gammas, unifs, (jz, jrate, jlp, jzs) = jax_chains["centroids"]
    calls = []
    terms = thmc._terms_fn(tm)

    def counted(z):
        calls.append(1)
        return terms(z)

    tz, trate, tlp, tzs = thmc.run_prior_chain(
        counted, torch.tensor(z0), torch.tensor(np.asarray(gammas)),
        torch.tensor(np.asarray(unifs)), thmc.HMCConfig(), collect_states=True)
    assert len(calls) == 1 + 100 * 16
    prev_t = np.concatenate([z0[None], tzs.numpy()[:-1]])
    prev_j = np.concatenate([z0[None], jzs[:-1]])
    flipped = np.any((np.any(tzs.numpy() != prev_t, axis=2)) != np.any(jzs != prev_j, axis=2),
                     axis=0)
    err = np.abs(tz.numpy() - jz) / np.maximum(1.0, np.abs(jz))
    print(f"100x15 chain vs JAX: {int(flipped.sum())} rows flipped, max z error "
          f"{float(err.max()):.3g} of max(1, |z|), accept rates {float(trate)} / {jrate}")
    assert flipped.sum() <= 1, flipped
    assert err[~flipped].max() <= 1e-5, err.max()
    assert trate > 0 and abs(trate - jrate) <= flipped.sum() / b
