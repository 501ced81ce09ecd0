"""The port's adaptive manifold HMC against the JAX package on the CPU: one
step of the adaptive and of the fixed-eps chain from JAX's own carry, whole
chains on JAX's draws (single-phase adaptive per chain and scalar, the
budgeted three-phase sampler, the calibration with a warm-start pool, the
planned chain on a JAX plan carried across by ``convert.plan_from_jax``),
and the host-side decisions (JAX's median, the sampling n_lf).

JAX's chains run its XLA terms (``_terms_fn(metric, "xla")``), the port's
the plain version of B4; the metric is ``metric_T0.7_scaled.npz`` at
T = 3.0.  JAX's carry after every MCMC step is read by running its own
chain function with ``jax.lax.scan`` replaced by an eager loop that keeps
each step's carry (:func:`_recorded`).

Tolerances, each with its reason:
- one step from JAX's carry: z and -grad within STEP_TOL = 3.6e-7 of
  max(1, |value|), the official chain's measured fp32 agreement
  (tests/test_torch_hmc.py); log pi within LP_ATOL = 1e-5, the terms' own
  tolerance there (a sum of 16 logs of fp32 pivots; measured 6e-6 at log
  pi ~ 15).  The dual-averaging state inherits it through alpha = exp(h0
  - h), h0 - h holding two log pi: h_bar within 2 LP_ATOL / (t + 1 + t0)
  (the update divides the statistic by t + 1 + t0), x and x_bar within
  that times sqrt(t + 1) / gamma (x = mu - sqrt(t + 1) / gamma h_bar).
- whole chains: the dual averaging feeds every step's acceptance
  probability, whose fp32 rounding (the two sides' terms differ in the
  last bits) moves the tuned eps by up to ~3e-5 relative (measured) and
  the trajectories after it.  Tuned eps within EPS_RTOL = 2e-4, states
  within CHAIN_TOL = 1e-3 of max(1, |z|) (measured: 8.2e-5 over the
  default budget sampler's 112 steps), log pi within CHAIN_TOL, accept rates within one
  accept per row-step of the compared chain; every integer exact.
- a row may leave JAX's chain only where the port saw a rounding-level
  tie, |alpha - u| < TIE_MARGIN = 1e-5 for the step's uniform u, on that
  row (for the scalar-eps chain, on any row: its eps is shared); such rows
  are counted and left out, any other divergence fails.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.samplers import hmc as jhmc
from rlvae_tpu_torch.convert import plan_from_jax
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.samplers import hmc as thmc

METRIC = Path(__file__).resolve().parents[1] / "data" / "pretrained" / "metric_T0.7_scaled.npz"
STEP_TOL = 3.6e-7
LP_ATOL = 1e-5
EPS_RTOL = 2e-4
CHAIN_TOL = 1e-3
TIE_MARGIN = 1e-5


@pytest.fixture(scope="module", autouse=True)
def jax_jitted_terms():
    """JAX's samplers evaluate their own XLA terms (``_terms_fn``) as one
    compiled program per shape instead of op by op: the arithmetic their
    scans compile anyway, at a fraction of the tracing time."""
    inner, cache = jhmc._terms_fn, {}

    def jitted(metric, backend):
        key = (id(metric), backend)
        if key not in cache:
            cache[key] = (metric, jax.jit(inner(metric, backend)))
        return cache[key][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhmc, "_terms_fn", jitted)
        yield


@pytest.fixture(scope="module")
def metrics():
    return (jax_load_metric(METRIC, temperature_override=3.0),
            load_metric(METRIC, temperature_override=3.0))


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(1.0, np.abs(want))


# ---------------------------------------------------------------------------
# the host-side decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 6, 50, 7])
def test_median_is_jnp_median(n):
    """jnp.median of an even count averages the two middle values, (lo +
    hi) * 0.5 in fp32; torch.median returns the lower one.  The port's
    ``jax_median`` is JAX's to the bit (ties and repeated values too)."""
    rng = np.random.default_rng(n)
    for x in (rng.lognormal(-4.5, 0.6, size=n).astype(np.float32),
              np.repeat(rng.uniform(0.001, 0.02, size=(n + 1) // 2), 2)[:n].astype(np.float32),
              np.float32([np.nextafter(np.float32(0.01), np.float32(1))] * (n - 1) + [0.01])):
        want = float(jnp.median(jnp.asarray(x)))
        assert thmc.jax_median(torch.from_numpy(x)) == want
    if n % 2 == 0:  # the trap: torch.median differs on an even count
        x = np.arange(1, n + 1, dtype=np.float32) * np.float32(0.003)
        assert float(torch.median(torch.from_numpy(x))) != float(jnp.median(jnp.asarray(x)))
        assert thmc.jax_median(torch.from_numpy(x)) == float(jnp.median(jnp.asarray(x)))


@pytest.mark.parametrize("lam,eps_med,want", [
    (0.45, 0.18, 2),      # 2.5 rounds half to even -> 2
    (0.45, 0.1, 4),       # 4.5 -> 4
    (0.45, 0.09, 5),      # 5.000000000000001 -> 5
    (0.45, 0.0125, 36),
    (0.45, 1e-9, 128),    # the 1e-6 floor, then the clip at n_lf_max
    (0.45, 1.0, 2),       # 0.45 -> 0, clipped to 2
])
def test_sampling_n_lf_rounds_as_python(lam, eps_med, want):
    """The sampling n_lf is decided in Python floats with ``round`` (half to
    even), as JAX's budget sampler and calibration write it."""
    assert thmc.sampling_n_lf(lam, eps_med, 128) == want
    assert int(np.clip(round(lam / max(eps_med, 1e-6)), 2, 128)) == want


def test_adaptive_constants_match_jax():
    for name in ("ADAPTIVE_WARMUP_A", "ADAPTIVE_NLF_A", "ADAPTIVE_TARGET_A", "ADAPTIVE_TARGET",
                 "ADAPTIVE_EPS_JITTER"):
        assert getattr(thmc, name) == getattr(jhmc, name), name
    for warmup in (1, 16, 24, 25, 40, 100):
        assert thmc.adaptive_warmup_b_steps(warmup) == jhmc.adaptive_warmup_b_steps(warmup)


# ---------------------------------------------------------------------------
# JAX's runs, with every MCMC step's carry
# ---------------------------------------------------------------------------


def _recorded(monkeypatch, fn, *args, **kwargs):
    """``fn`` (a JAX sampler) run with the MCMC loops' ``jax.lax.scan``
    replaced by a Python loop over JAX's own step function (jitted once),
    the leapfrog loop left as it is.  Returns (its result, one list per MCMC
    loop of the carries before the first step and after every step)."""
    runs, scan = [], jax.lax.scan

    def recording_scan(f, init, xs=None, length=None):
        if xs is None:  # the leapfrog loop
            return scan(f, init, xs, length=length)
        step, carry, ys, carries = jax.jit(f), init, [], [init]
        for i in range(jax.tree_util.tree_leaves(xs)[0].shape[0]):
            carry, y = step(carry, jax.tree_util.tree_map(lambda a: a[i], xs))
            carries.append(carry)
            ys.append(y)
        runs.append([tuple(np.asarray(a) for a in c) for c in carries])
        return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "scan", recording_scan)
        out = fn(*args, **kwargs)
    return out, runs


def _np(diag):
    return {k: v if isinstance(v, (int, float)) else np.asarray(v) for k, v in diag.items()}


def _jax_draws(jm, seed, steps, b):
    """The draws of JAX's single-phase samplers from PRNGKey(seed)."""
    k_init, k_chain = jax.random.split(jax.random.PRNGKey(seed))
    z0 = np.asarray(jm.centroids)[np.asarray(jax.random.randint(k_init, (b,), 0, jm.n_centroids))]
    gammas, unifs = jhmc.draw_chain_noise(k_chain, steps, b, 16)
    return z0, gammas, unifs


SINGLE = dict(b=6, steps=20, n_lf=5, warmup=10, seed=31)


@pytest.fixture(scope="module")
def jax_adaptive():
    """JAX's single-phase adaptive sampler (20 steps x 5 leapfrog, warmup 10)
    at B=6, per chain and scalar: {per_chain: (draws, zs, diagnostics,
    carries)}."""
    jm = jax_load_metric(METRIC, temperature_override=3.0)
    cfg = jhmc.HMCConfig(mcmc_steps=SINGLE["steps"], n_lf=SINGLE["n_lf"], init="centroids",
                         backend="xla")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for per_chain in (True, False):
            (zs, diag), runs = _recorded(
                mp, jhmc.sample_prior_hmc_adaptive, jm, jax.random.PRNGKey(SINGLE["seed"]),
                SINGLE["b"], cfg, warmup=SINGLE["warmup"], per_chain=per_chain,
                return_chain=True)
            out[per_chain] = (_jax_draws(jm, SINGLE["seed"], SINGLE["steps"], SINGLE["b"]),
                              np.asarray(zs), _np(diag), runs[0])
    return out


def _budget_draws(jm, key, b, steps_s):
    """The draws of JAX's budget sampler from ``key`` (rlvae_tpu/samplers/
    hmc.py:451-490), for a sampling phase of ``steps_s`` steps."""
    k_init, k_w, k_s, k_j = jax.random.split(key, 4)
    z0 = jm.centroids[jax.random.randint(k_init, (b,), 0, jm.n_centroids)]
    g_a, u_a = jhmc.draw_chain_noise(k_w, jhmc.ADAPTIVE_WARMUP_A, b, 16)
    g_b, u_b = jhmc.draw_chain_noise(jax.random.fold_in(k_w, 1),
                                     jhmc.adaptive_warmup_b_steps(jhmc.ADAPTIVE_WARMUP_A), b, 16)
    g_s, u_s = jhmc.draw_chain_noise(k_s, steps_s, b, 16)
    jit = 1.0 + jhmc.ADAPTIVE_EPS_JITTER * (2.0 * jax.random.uniform(k_j, (steps_s, b)) - 1.0)
    return {k: _t(v) for k, v in dict(z0=z0, gammas_a=g_a, unifs_a=u_a, gammas_b=g_b,
                                       unifs_b=u_b, gammas_s=g_s, unifs_s=u_s,
                                       jitters=jit).items()}


BUDGET_LF = 800  # leapfrog steps per chain (default: the official chain's 1500)


@pytest.fixture(scope="module")
def jax_budget():
    """JAX's budget sampler (its default phases A and B, a budget of
    BUDGET_LF), B=6, key 7: (draws, zs, diagnostics, carries of phases A, B
    and C)."""
    jm = jax_load_metric(METRIC, temperature_override=3.0)
    key, b = jax.random.PRNGKey(7), 6
    with pytest.MonkeyPatch.context() as mp:
        (zs, diag), runs = _recorded(mp, jhmc.sample_prior_hmc_adaptive_budget, jm, key, b,
                                     jhmc.HMCConfig(init="centroids", backend="xla"),
                                     budget_lf=BUDGET_LF, return_chain=True)
    diag = _np(diag)
    assert len(runs) == 3
    return _budget_draws(jm, key, b, diag["steps_sampling"]), np.asarray(zs), diag, runs


# ---------------------------------------------------------------------------
# one step from JAX's carry
# ---------------------------------------------------------------------------


def _step_cases():
    """(label, fixture, phase, steps): phase A of the budget sampler (fresh
    eps, target 0.75), its phase B (per-chain warm-started eps), the
    single-phase chains per chain and scalar (adapting and frozen steps)."""
    return [("budget-A", "budget", 0, (0, 1, 38, 39)), ("budget-B", "budget", 1, (0, 1, 12)),
            ("single-per-chain", True, 0, (0, 9, 10, 19)),
            ("single-scalar", False, 0, (0, 9, 10, 19))]


@pytest.mark.parametrize("label,which,phase,steps", _step_cases(), ids=lambda v: str(v))
def test_adaptive_step_from_jax_carry(metrics, jax_budget, jax_adaptive, label, which, phase,
                                      steps):
    """MCMC steps of the port started from JAX's carry (z, log pi, -grad, x,
    x_bar, h_bar) with JAX's draws, against JAX's next carry."""
    _, tm = metrics
    if which == "budget":
        noise, _, diag, runs = jax_budget
        carries = runs[phase]
        tag = "ab"[phase]
        gammas, unifs = noise[f"gammas_{tag}"], noise[f"unifs_{tag}"]
        if phase == 0:
            n_lf, target, warmup, eps0 = jhmc.ADAPTIVE_NLF_A, jhmc.ADAPTIVE_TARGET_A, 40, 0.03
        else:  # warm-started from phase A's eps, as JAX computes it
            n_lf, target, warmup = diag["n_lf_sampling"], jhmc.ADAPTIVE_TARGET, 13
            eps0 = np.array(jnp.exp(jnp.asarray(runs[0][-1][4])))
        per_chain = True
    else:
        (_, gammas, unifs), _, _, carries = jax_adaptive[which]
        gammas, unifs = _t(gammas), _t(unifs)
        n_lf, target, warmup, eps0, per_chain = (SINGLE["n_lf"], 0.65, SINGLE["warmup"], 0.03,
                                                 which)
    eps0 = torch.as_tensor(eps0, dtype=torch.float32)
    da = thmc.DualAveraging(torch.log(10.0 * eps0), target, warmup, per_chain)
    worst = {}
    for s in steps:
        got, _, _ = thmc.adaptive_mcmc_step(thmc._terms_fn(tm), tuple(_t(a) for a in carries[s]),
                                            gammas[s], unifs[s], s, n_lf, da)
        h_bar_tol = 2 * LP_ATOL / (s + 1 + thmc.DA_T0)
        tols = {"z": STEP_TOL, "-grad": STEP_TOL, "h_bar": h_bar_tol,
                "x": h_bar_tol * np.sqrt(s + 1.0) / thmc.DA_GAMMA}
        tols["x_bar"] = tols["x"]
        for name, g, w in zip(("z", "log_pi", "-grad", "x", "x_bar", "h_bar"), got,
                              carries[s + 1]):
            if name == "log_pi":
                err, tol = float(np.abs(g.numpy() - w).max()), LP_ATOL
            else:
                err, tol = float(_rel(g.numpy(), w).max()), tols[name]
            worst[name] = max(worst.get(name, 0.0), err / tol)
            assert err <= tol, (label, s, name, err, tol)
    print(label, {k: f"{v:.2f} of tol" for k, v in worst.items()})


def test_fixed_step_from_jax_carry(metrics, jax_budget):
    """Fixed-eps steps (the budget sampler's phase C: the tuned per-chain eps
    times each step's jitter) from JAX's carry (z, log pi, -grad), against
    JAX's next carry."""
    _, tm = metrics
    noise, _, diag, runs = jax_budget
    carries, eps = runs[2], torch.tensor(diag["eps_tuned"])
    last = diag["steps_sampling"] - 1
    for s in (0, 1, last):
        got, _, _ = thmc.fixed_mcmc_step(thmc._terms_fn(tm), tuple(_t(a) for a in carries[s]),
                                         noise["gammas_s"][s], noise["unifs_s"][s],
                                         eps * noise["jitters"][s], diag["n_lf_sampling"])
        for name, g, w in zip(("z", "log_pi", "-grad"), got, carries[s + 1]):
            if name == "log_pi":
                err, tol = float(np.abs(g.numpy() - w).max()), LP_ATOL
            else:
                err, tol = float(_rel(g.numpy(), w).max()), STEP_TOL
            assert err <= tol, (s, name, err)


# ---------------------------------------------------------------------------
# whole chains on JAX's draws
# ---------------------------------------------------------------------------


class StepLog:
    """Wraps the port's step functions (looked up by name in the module) and
    keeps each call's alpha and uniforms, in call order."""

    def __init__(self, monkeypatch):
        self.steps = []
        for name in ("adaptive_mcmc_step", "fixed_mcmc_step"):
            inner = getattr(thmc, name)

            def wrapped(terms, carry, gamma, accept_u, *rest, _inner=inner):
                out = _inner(terms, carry, gamma, accept_u, *rest)
                self.steps.append((out[2].numpy(), accept_u.numpy()))
                return out

            monkeypatch.setattr(thmc, name, wrapped)

    def tie_rows(self, rows: int) -> np.ndarray:
        """Rows (of the chains with ``rows`` rows) with a rounding-level tie
        |alpha - u| < TIE_MARGIN at any step."""
        ties = [np.abs(alpha - u) < TIE_MARGIN for alpha, u in self.steps if len(u) == rows]
        return np.any(ties, axis=0) if ties else np.zeros(rows, bool)


def _compare_chain(got_zs, want_zs, z0, log, shared_eps=False):
    """Per-step states of two chains from the start ``z0`` (None: a start
    not known on JAX's side; the first step's decision is then read from
    its state alone): the rows that leave JAX's chain (an accept decided
    otherwise, or a state beyond CHAIN_TOL) must be tie rows of ``log``
    (with ``shared_eps``, any tie counts for every row).  Returns (rows
    kept, number of rows left out, max error)."""
    got_zs, want_zs = np.asarray(got_zs), np.asarray(want_zs)
    moved_g = np.any(got_zs[1:] != got_zs[:-1], axis=2)
    moved_w = np.any(want_zs[1:] != want_zs[:-1], axis=2)
    if z0 is not None:
        moved_g = np.concatenate([np.any(got_zs[:1] != z0, axis=2), moved_g])
        moved_w = np.concatenate([np.any(want_zs[:1] != z0, axis=2), moved_w])
    flipped = np.any(moved_g != moved_w, axis=0)
    err = _rel(got_zs, want_zs).max(axis=(0, 2))
    left = flipped | (err > CHAIN_TOL)
    ties = log.tie_rows(got_zs.shape[1])
    if shared_eps and ties.any():
        ties = np.ones_like(ties)
    assert not np.any(left & ~ties), (np.flatnonzero(left & ~ties), err)
    keep = ~left
    return keep, int(left.sum()), float(err[keep].max()) if keep.any() else 0.0


@pytest.mark.parametrize("per_chain", [True, False])
def test_sample_prior_hmc_adaptive_matches_jax(metrics, jax_adaptive, monkeypatch, per_chain):
    """``sample_prior_hmc_adaptive`` (through the port's
    ``run_adaptive_prior_chain``) on JAX's draws: every step's states, the
    final eps, log pi and the post-warmup accept statistics."""
    _, tm = metrics
    (z0, gammas, unifs), jzs, jdiag, _ = jax_adaptive[per_chain]
    b, steps = SINGLE["b"], SINGLE["steps"]
    log = StepLog(monkeypatch)
    zs, diag = thmc.sample_prior_hmc_adaptive(
        tm, b, thmc.HMCConfig(mcmc_steps=steps, n_lf=SINGLE["n_lf"]), warmup=SINGLE["warmup"],
        per_chain=per_chain, return_chain=True,
        noise={"z0": _t(z0), "gammas": _t(gammas), "unifs": _t(unifs)})
    assert len(log.steps) == steps
    keep, n_left, err = _compare_chain(zs, jzs, z0, log, shared_eps=not per_chain)
    print(f"adaptive per_chain={per_chain}: {n_left} rows left at a tie, max z error {err:.3g}")
    eps, want_eps = diag["eps_final"].numpy(), jdiag["eps_final"]
    if per_chain:
        eps, want_eps = eps[keep], want_eps[keep]
    np.testing.assert_allclose(eps, want_eps, rtol=EPS_RTOL)
    np.testing.assert_array_less(_rel(diag["log_pi"].numpy()[keep], jdiag["log_pi"][keep]),
                                 CHAIN_TOL)
    if n_left == 0:
        n_post = steps - SINGLE["warmup"]
        assert abs(float(diag["accept_rate"]) - float(jdiag["accept_rate"])) <= 1 / (b * n_post)
        assert abs(float(diag["accept_prob_mean"]) - float(jdiag["accept_prob_mean"])) <= 1e-4


def test_budget_sampler_matches_jax(metrics, jax_budget, monkeypatch):
    """The budgeted sampler (phase A 40 x 5, phase B 13 x n_lf, phase C
    fixed eps with jitter to BUDGET_LF leapfrog steps; the default budget
    runs in test_torch_generate_adaptive.py and chip_smoke.py) at B=6 on
    JAX's draws: n_lf_sampling, steps_sampling and leapfrog_spent equal to
    JAX's, the phase-B eps, the phase-C states per step, log pi and the
    accept rates."""
    _, tm = metrics
    noise, jzs, jdiag, _ = jax_budget
    log = StepLog(monkeypatch)
    zs, diag = thmc.sample_prior_hmc_adaptive_budget(tm, 6, thmc.HMCConfig(), budget_lf=BUDGET_LF,
                                                     noise=noise, return_chain=True)
    for k in ("n_lf_sampling", "steps_sampling", "leapfrog_spent"):
        assert type(diag[k]) is int and diag[k] == jdiag[k], (k, diag[k], jdiag[k])
    assert diag["leapfrog_spent"] <= BUDGET_LF
    assert len(log.steps) == 40 + 13 + diag["steps_sampling"]
    keep, n_left, err = _compare_chain(zs, jzs, None, log)
    print(f"budget sampler: n_lf {diag['n_lf_sampling']}, {diag['steps_sampling']} steps, "
          f"{n_left} rows left at a tie, max z error {err:.3g}")
    np.testing.assert_allclose(diag["eps_tuned"].numpy()[keep], jdiag["eps_tuned"][keep],
                               rtol=EPS_RTOL)
    np.testing.assert_array_less(_rel(diag["log_pi"].numpy()[keep], jdiag["log_pi"][keep]),
                                 CHAIN_TOL)
    if n_left == 0:
        steps = diag["steps_sampling"]
        assert abs(float(diag["accept_rate"]) - float(jdiag["accept_rate"])) <= 1 / (6 * steps)
        assert abs(float(diag["warmup_accept_rate"])
                   - float(jdiag["warmup_accept_rate"])) <= 1 / (6 * 7)


POOL, SPREAD, CAL_WARMUP = 16, 6, 16  # phase A 16 x 5, phase B max(8, 16 // 3) = 8 steps


@pytest.fixture(scope="module")
def jax_plan():
    """JAX's calibration with a 16-step phase A (8 steps of phase B), a
    16-entry pool spread 6 steps, key 12, and its draws
    (rlvae_tpu/samplers/hmc.py:555-598)."""
    jm = jax_load_metric(METRIC, temperature_override=3.0)
    key = jax.random.PRNGKey(12)
    plan = jhmc.calibrate_adaptive_plan(jm, key, jhmc.HMCConfig(init="centroids", backend="xla"),
                                        warmup=CAL_WARMUP, pool_size=POOL, spread_steps=SPREAD)
    k_a, k_b = jax.random.split(key)
    g_a, u_a = jhmc.draw_chain_noise(k_a, CAL_WARMUP, 50, 16)
    g_b, u_b = jhmc.draw_chain_noise(k_b, jhmc.adaptive_warmup_b_steps(CAL_WARMUP), 50, 16)
    k_i, k_s, k_j = jax.random.split(jax.random.fold_in(key, 2), 3)
    g_p, u_p = jhmc.draw_chain_noise(k_s, SPREAD, POOL, 16)
    noise = dict(gammas_a=g_a, unifs_a=u_a, gammas_b=g_b, unifs_b=u_b,
                 cidx=jax.random.randint(k_i, (POOL,), 0, 50), gammas_p=g_p, unifs_p=u_p,
                 jitters_p=1.0 + 0.2 * (2.0 * jax.random.uniform(k_j, (SPREAD, POOL)) - 1.0))
    return {k: v if isinstance(v, (int, float)) else np.asarray(v) for k, v in plan.items()}, \
        {k: _t(v) for k, v in noise.items()}


def test_calibrate_adaptive_plan_matches_jax(metrics, jax_plan, monkeypatch):
    """The calibration (K=50 chains from the centroids, phase A 16 x 5,
    phase B 8 x n_lf, a 16-entry pool spread 6 fixed-eps steps) on JAX's
    draws: every integer of the plan equal, the per-centroid eps, phase B's
    accept rate, the pool's states and eps."""
    _, tm = metrics
    jplan, noise = jax_plan
    log = StepLog(monkeypatch)
    plan = thmc.calibrate_adaptive_plan(tm, thmc.HMCConfig(), warmup=CAL_WARMUP, pool_size=POOL,
                                        spread_steps=SPREAD, noise=noise)
    assert sorted(plan) == sorted(jplan)
    for k in ("n_lf", "calibration_lf", "chains"):
        assert type(plan[k]) is int and plan[k] == jplan[k], (k, plan[k], jplan[k])
    assert plan["path_length"] == jplan["path_length"]
    n_lf = plan["n_lf"]
    assert plan["calibration_lf"] == 50 * (CAL_WARMUP * 5 + 8 * n_lf) + POOL * SPREAD * n_lf
    eps_left = np.abs(plan["eps"].numpy() - jplan["eps"]) > EPS_RTOL * np.abs(jplan["eps"])
    assert not np.any(eps_left & ~log.tie_rows(50)), np.flatnonzero(eps_left)
    cidx = noise["cidx"].numpy()
    pool_left = (_rel(plan["pool"].numpy(), jplan["pool"]).max(1) > CHAIN_TOL) | eps_left[cidx]
    assert not np.any(pool_left & ~(log.tie_rows(POOL) | eps_left[cidx])), pool_left
    np.testing.assert_array_equal(plan["pool_eps"].numpy(), plan["eps"].numpy()[cidx])
    np.testing.assert_allclose(plan["pool_eps"].numpy()[~pool_left], jplan["pool_eps"][~pool_left],
                               rtol=EPS_RTOL)
    print(f"calibration: n_lf {plan['n_lf']}, eps {float(plan['eps'].min()):.4g}-"
          f"{float(plan['eps'].max()):.4g}, {int(eps_left.sum())} chains and "
          f"{int(pool_left.sum())} pool rows left at a tie")
    if not eps_left.any():
        assert abs(plan["accept_rate"] - jplan["accept_rate"]) <= 1 / (50 * 4)


def test_plan_from_jax_round_trip(jax_plan):
    """A JAX plan carried across: arrays as fp32 tensors (bit for bit),
    integers as ints, the rest as floats; and back to numpy unchanged."""
    jplan, _ = jax_plan
    plan = plan_from_jax(jplan, torch.device("cpu"))
    assert sorted(plan) == sorted(jplan)
    for k, v in jplan.items():
        if np.ndim(v):
            assert plan[k].dtype == torch.float32 and plan[k].device.type == "cpu"
            np.testing.assert_array_equal(plan[k].numpy(), v)
        else:
            assert type(plan[k]) is type(v) and plan[k] == v, (k, plan[k], v)
    assert {k for k, v in plan.items() if isinstance(v, int)} == {"n_lf", "calibration_lf",
                                                                  "chains"}


def test_planned_chain_on_a_jax_plan_matches_jax(metrics, jax_plan, monkeypatch):
    """``sample_prior_hmc_planned`` on JAX's plan (through ``plan_from_jax``)
    and JAX's draws (a permutation's first 6 pool slots, 12 steps with
    jitter at the plan's n_lf): every step's states, log pi, accept rate."""
    jm, tm = metrics
    jplan, _ = jax_plan
    key, n, steps = jax.random.PRNGKey(9), 6, 12
    jzs, jdiag = jhmc.sample_prior_hmc_planned(
        jm, key, n, jplan, steps=steps, config=jhmc.HMCConfig(backend="xla"), return_chain=True)
    k_init, k_s, k_j = jax.random.split(key, 3)
    g_s, u_s = jhmc.draw_chain_noise(k_s, steps, n, 16)
    noise = {"idx": _t(jax.random.permutation(k_init, POOL)[:n]), "gammas": _t(g_s),
             "unifs": _t(u_s),
             "jitters": _t(1.0 + 0.2 * (2.0 * jax.random.uniform(k_j, (steps, n)) - 1.0))}
    log = StepLog(monkeypatch)
    zs, diag = thmc.sample_prior_hmc_planned(tm, n, plan_from_jax(jplan), steps, noise=noise,
                                             return_chain=True)
    assert len(log.steps) == steps
    z0 = jplan["pool"][noise["idx"].numpy()]
    keep, n_left, err = _compare_chain(zs, jzs, z0, log)
    print(f"planned chain: {n_left} rows left at a tie, max z error {err:.3g}")
    np.testing.assert_array_less(_rel(diag["log_pi"].numpy()[keep],
                                      np.asarray(jdiag["log_pi"])[keep]), CHAIN_TOL)
    if n_left == 0:
        assert abs(float(diag["accept_rate"]) - float(jdiag["accept_rate"])) <= 1 / (n * steps)
