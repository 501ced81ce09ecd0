"""The port's LLDM and its pieces (``rlvae_tpu_torch.models.research.lldm``)
against the JAX package's on the CPU.

JAX's own small sizes (``tests/test_research_models.py``): frames 3x8x8,
latent 6, 4 visits, hidden 16; MLP nets 192->16->6 in fp32 (``dtype:
float32``, so both sides run the same fp32 operations), B=3.  One set of
JAX variables (``init(PRNGKey(0))``) is carried into the port by
``convert.research_state_from_jax`` (the posterior IAF, a context weight
``cw`` and the VAMP ``pseudo_inputs`` included) and the frozen eps-net by
``convert.ldm_state_from_jax``.  JAX's own draws are handed to the port as
``noise``, by JAX's key splits (module docstring of ``lldm.py``): the
bridge takes one ``normal(split(key)[1])`` per step of the chained key.

Tolerances: fp32 on both sides, sums taken in another order.  Losses,
latents, log_pi, G and the NLL rtol 1e-5 (atol 1e-5; the NLL ~1e2, atol
1e-3); reconstructions atol 1e-5; gradients within 1e-4 of each tensor's
largest entry (the backward sums over B*T frames); the eps-net's outputs
and one Adam step of its pre-training 1e-5; the schedule tables, the
medoids and the temperature bitwise (numpy on the host on both sides, on
the same mu; ``generate`` runs on JAX's metric, since a two-member
cluster's medoid is a tie that the encoders' rounding may break).
HMC: a row may leave JAX's chain only at a tie, |u - exp(h0 - h1)| <
TIE_MARGIN at one of its steps (ROADMAP C3); the rows that stay agree
within 1e-4 of max(1, |z|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlvae_tpu.models.research.lldm as jl
from rlvae_tpu.flows.iaf import iaf_inverse as jax_iaf_inverse
from rlvae_tpu.flows.iaf import iaf_masks, init_iaf
from rlvae_tpu_torch.convert import ldm_state_from_jax, research_state_from_jax
from rlvae_tpu_torch.flows.iaf import IAF, iaf_inverse
from rlvae_tpu_torch.models.research import (
    LLDM,
    DDIMSampler,
    LatentDiffusion,
    SampledMetric,
    pretrain_latent_diffusion,
)
from rlvae_tpu_torch.models.research.lldm import _sinusoidal_embedding, hmc_sampling, retrieve_g

INPUT, LATENT, N_OBS, B = (3, 8, 8), 6, 4, 3
NET = {"architecture": "mlp", "hidden_dims": [16], "dtype": "float32"}
KW = dict(input_dim=INPUT, latent_dim=LATENT, n_obs=N_OBS, warmup=2, hidden_size=16,
          vamp_number_components=4, encoder_config=NET, decoder_config=NET)
RTOL, ATOL, GRAD_RTOL, TIE_MARGIN = 1e-5, 1e-5, 1e-4, 1e-3
OUT_KEYS = ("loss", "reconstruction_loss", "reg_loss", "recon_x", "z", "z_seq")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_metric():
    rng = np.random.default_rng(5)
    c = rng.normal(size=(5, LATENT)).astype(np.float32)
    m = np.exp(0.3 * rng.normal(size=(5, LATENT))).astype(np.float32)
    return jl.SampledMetric(c, m, 1.7, 0.01), SampledMetric(c, m, 1.7, 0.01)


def pair(metric=False, **kw):
    """(JAX model, its variables, the port model carrying them), the same
    sampled metric attached to both when ``metric``."""
    jmet, pmet = jax_metric() if metric else (None, None)
    jm = jl.LLDM(**{**KW, **kw}, pretrained_metric=jmet)
    jv = _np(jm.init(jax.random.PRNGKey(0)))
    pm = LLDM(**{**KW, **kw}, pretrained_metric=pmet)
    pm.load_state_dict({**research_state_from_jax(jv),
                        **ldm_state_from_jax(_np(jm.ldm.params), "ldm.")})
    return jm, jv, pm


@pytest.fixture(scope="module")
def base():
    return pair()


def batch(b=B, seed=1):
    return np.random.default_rng(seed).uniform(size=(b, N_OBS, *INPUT)).astype(np.float32)


def bridge(key, steps, shape):
    """JAX's draws of one ``_propagate``: per step ``key, k = split(key)``."""
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, shape)))
    return np.stack(out) if out else np.zeros((0, *shape), np.float32)


def steps_of(vi, n=N_OBS, future_only=False):
    return (0 if future_only else vi) + n - 1 - vi


def hmc_draws(key, n, steps, n_rows):
    """JAX's ``hmc_sampling`` draws: ``idx``, then per step ``rho`` and ``u``."""
    k_init, k_scan = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_init, (n,), 0, n_rows))
    rho, u = [], []
    for k in jax.random.split(k_scan, steps):
        k_m, k_a = jax.random.split(k)
        rho.append(np.asarray(jax.random.normal(k_m, (n, LATENT))))
        u.append(np.asarray(jax.random.uniform(k_a, (n,))))
    return {"idx": idx, "rho": np.stack(rho), "u": np.stack(u)}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def grads_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k] if got[k] is not None else torch.zeros_like(w)
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max())
        assert err <= GRAD_RTOL * scale, (k, err, scale)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_embedding_epsnet_and_latent_diffusion():
    ts = np.array([0.0, 3.0, 250.0, 999.0, 17.5], np.float32)
    close(_sinusoidal_embedding(t(ts)), jl._sinusoidal_embedding(jnp.asarray(ts)))
    jldm = jl.LatentDiffusion(LATENT, hidden=32, key=jax.random.PRNGKey(4))
    ldm = LatentDiffusion(LATENT, hidden=32)
    ldm.load_state_dict(ldm_state_from_jax(_np(jldm.params)))
    assert np.array_equal(ldm.alpha_bar, np.asarray(jldm.alpha_bar))
    assert (ldm.c, ldm.h, ldm.w) == (jldm.c, jldm.h, jldm.w)
    z = np.random.default_rng(2).normal(size=(5, LATENT)).astype(np.float32)
    want = jax.jit(lambda zz, tt: (jldm(zz, 125.0), jldm(zz, tt)))(jnp.asarray(z),
                                                                 jnp.asarray(ts))
    with torch.no_grad():
        close(ldm(t(z), 125.0), want[0])
        close(ldm(t(z), t(ts)), want[1])
        close(ldm.net(t(z), t(ts)), want[1])
    assert not any(p.requires_grad for p in ldm.parameters())


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_sequential_diffusion_and_ddim_step(eta):
    jldm, ldm = jl.LatentDiffusion(4), LatentDiffusion(4)
    ldm.load_state_dict(ldm_state_from_jax(_np(jldm.params)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(key, x.shape))
    for t1, t2 in ((100, 700), (0, 999), (400, 400)):
        want = jldm.sequential_diffusion(key, jnp.asarray(x), np.full(3, t1), np.full(3, t2))
        close(ldm.sequential_diffusion(t(x), t1, t2, t(eps)), want)
        close(ldm.sequential_diffusion(t(x), np.full(3, t1), np.full(3, t2), t(eps)), want)
    js, ps = jl.DDIMSampler(jldm, n_steps=5, ddim_eta=eta), DDIMSampler(ldm, n_steps=5,
                                                                        ddim_eta=eta)
    assert np.array_equal(ps.time_steps, js.time_steps)
    for name in ("ddim_alpha", "ddim_alpha_prev", "ddim_sigma"):
        assert np.array_equal(getattr(ps, name), np.asarray(getattr(js, name))), name
    e_t = rng.normal(size=(3, 4)).astype(np.float32)
    for idx in range(5):
        for repeat in (False, True):
            k = jax.random.PRNGKey(idx)
            want = js.get_x_prev_and_pred_x0(k, jnp.asarray(e_t), idx, jnp.asarray(x),
                                             temperature=0.8, repeat_noise=repeat)
            n = np.asarray(jax.random.normal(k, (1, 4) if repeat else (3, 4)))
            got = ps.get_x_prev_and_pred_x0(t(e_t), idx, t(x), t(n), temperature=0.8,
                                            repeat_noise=repeat)
            close(got[0], want[0], what=f"x_prev {idx}")
            close(got[1], want[1], what=f"pred_x0 {idx}")


def test_sampled_metric_g_and_log_pi():
    jmet, pmet = jax_metric()
    z = np.random.default_rng(3).normal(size=(7, LATENT)).astype(np.float32)
    want = jax.jit(lambda v: (jmet.g_diag(v), jmet.g(v), jmet.log_pi(v),
                              jax.grad(lambda u: jnp.sum(jmet.log_pi(u)))(v)))(jnp.asarray(z))
    close(pmet.g_diag(t(z)), want[0])
    close(pmet.g(t(z)), want[1])
    close(pmet.log_pi(t(z)), want[2])
    zt = t(z).requires_grad_(True)
    pmet.log_pi(zt).sum().backward()
    close(zt.grad, want[3], atol=1e-5)


def test_retrieve_g_medoids_temperature_and_std_norm():
    rng = np.random.default_rng(4)
    mu = rng.normal(size=(40, LATENT)).astype(np.float32)
    lv = rng.normal(scale=0.3, size=(40, LATENT)).astype(np.float32)
    for k, mult, std_norm in ((6, 1.0, False), (6, 0.5, True), (40, 2.0, False), (1, 1.0, True)):
        want = jl.retrieve_g(mu, lv, k, mult, std_norm)
        got = retrieve_g(mu, lv, k, mult, std_norm)
        assert np.array_equal(got.centroids.numpy(), np.asarray(want.centroids))
        assert np.array_equal(got.m_flat.numpy(), np.asarray(want.m_flat))
        assert got.temperature == want.temperature and got.lbd == want.lbd


def test_hmc_sampling_counts_ties():
    jmet, pmet = jax_metric()
    mu = np.random.default_rng(6).normal(scale=1.5, size=(20, LATENT)).astype(np.float32)
    key, n, steps = jax.random.PRNGKey(8), 16, 6
    want_z, want_lp = jl.hmc_sampling(jmet, jnp.asarray(mu), key, n, steps, n_lf=4, eps_lf=0.05)
    trace = []
    got_z, got_lp = hmc_sampling(pmet, t(mu), n, steps, n_lf=4, eps_lf=0.05,
                                 noise=hmc_draws(key, n, steps, 20), trace=trace)
    ties = np.any([np.abs(u.numpy() - a.numpy()) < TIE_MARGIN for u, a, _, _ in trace], axis=0)
    accepts = sum(int(acc.sum()) for _, _, acc, _ in trace)
    assert torch.equal(trace[-1][3], got_z)
    assert 0 < accepts < n * steps, accepts
    scale = np.maximum(np.abs(np.asarray(want_z)).max(1, keepdims=True), 1.0)
    left = np.any(np.abs(got_z.numpy() - np.asarray(want_z)) > 1e-4 * scale, axis=1)
    assert not np.any(left & ~ties), np.flatnonzero(left & ~ties)
    assert left.sum() <= 1
    close(got_lp.numpy()[~left], np.asarray(want_lp)[~left], rtol=1e-4, atol=1e-4)


def test_pretrain_step_matches_optax():
    lat = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    want = jl.pretrain_latent_diffusion(key, jnp.asarray(lat), hidden=32, n_steps=1,
                                        batch_size=16)
    init = jl.LatentDiffusion(4, hidden=32, key=key)
    _, k = jax.random.split(key)
    k_i, k_t, k_e = jax.random.split(k, 3)
    noise = {"idx": np.asarray(jax.random.randint(k_i, (16,), 0, 64))[None],
             "t": np.asarray(jax.random.randint(k_t, (16,), 0, 1000))[None],
             "eps": np.asarray(jax.random.normal(k_e, (16, 4)))[None]}
    ldm = LatentDiffusion(4, hidden=32)
    ldm.load_state_dict(ldm_state_from_jax(_np(init.params)))
    got = pretrain_latent_diffusion(t(lat), hidden=32, n_steps=1, batch_size=16, ldm=ldm,
                                    noise=noise)
    for name, w in ldm_state_from_jax(_np(want.params)).items():
        moved = w - ldm_state_from_jax(_np(init.params))[name]
        assert float(moved.abs().max()) > 1e-4, name  # the step moved every tensor
        close(got.state_dict()[name], w, atol=1e-6, what=name)
    assert not any(p.requires_grad for p in got.parameters())


def test_context_weight_is_carried_and_used():
    """MADE's optional context weight: JAX's ``init_iaf(context_dim=...)``
    carried by ``research_state_from_jax``, and ``iaf_inverse`` with a
    context ``h`` against JAX's."""
    params = _np(init_iaf(jax.random.PRNGKey(2), LATENT, 16, 3, 2, context_dim=5))
    flow = IAF(LATENT, 16, 3, 2, context_dim=5)
    flow.load_state_dict({k.split(".", 1)[1]: v for k, v in research_state_from_jax(
        {"posterior_flow": params}).items()})
    rng = np.random.default_rng(9)
    y, h = rng.normal(size=(4, LATENT)).astype(np.float32), rng.normal(size=(4, 5)).astype(
        np.float32)
    masks = iaf_masks(LATENT, 16, 2)
    inverse = jax.jit(lambda p, yy, hh: jax_iaf_inverse(p, masks, yy, hh))
    with torch.no_grad():
        for ctx in (None, h):
            want = inverse(params, jnp.asarray(y), None if ctx is None else jnp.asarray(ctx))
            got = iaf_inverse(flow, t(y), None if ctx is None else t(ctx))
            close(got[0], want[0])
            close(got[1], want[1])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

# (prior, posterior, epoch, visit, metric attached): the prior reaches only
# the warmup objective (its three loss functions); the visit branch at a
# middle visit (no KL) and at both ends, the last against the metric
FORWARD_CASES = [
    ("standard", "gaussian", 0, None, False),
    ("standard", "gaussian", 5, 1, False),
    ("standard", "gaussian", 5, 0, True),
    ("standard", "gaussian", 5, 3, True),
    ("vamp", "gaussian", 0, None, False),
    ("standard", "iaf", 0, None, False),
    ("standard", "iaf", 5, 3, True),
    ("vamp", "iaf", 0, None, False),
]


@pytest.mark.parametrize("prior,posterior,epoch,vi,metric", FORWARD_CASES)
def test_forward_and_gradients(prior, posterior, epoch, vi, metric):
    """A train forward (the warmup branch, a middle visit, a boundary visit
    against the metric's volume or N(0, I)) and its gradients."""
    jm, jv, pm = pair(metric=metric, prior=prior, posterior=posterior,
                      linear_scheduling_steps=8, context_dim=3 if posterior == "iaf" else None)
    x, key = batch(), jax.random.PRNGKey(3)
    kw = dict(vi_index=vi, epoch=epoch, train=True)

    def loss(p):
        out = jm.forward({"params": p}, jnp.asarray(x), key, **kw)
        return out.loss, {k: out[k] for k in OUT_KEYS}

    (_, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    jg = research_state_from_jax(_np(jg))
    if epoch < KW["warmup"]:
        noise = {"eps": np.asarray(jax.random.normal(jax.random.split(key)[0],
                                                     (B * N_OBS, LATENT)))}
    else:
        k_s, _, k_p = jax.random.split(key, 3)
        noise = {"eps": np.asarray(jax.random.normal(k_s, (B, LATENT))),
                 "bridge": bridge(k_p, steps_of(vi), (B, LATENT))}
    pm.zero_grad()
    pout = pm(t(x), noise={k: t(v) for k, v in noise.items()}, **kw)
    pout.loss.backward()
    for k in ("loss", "reconstruction_loss", "reg_loss", "z", "z_seq"):
        close(pout[k], jout[k], what=k)
    close(pout["recon_x"], jout["recon_x"], rtol=0, what="recon_x")
    assert pout.vi_index == (-1 if epoch < KW["warmup"] else vi)
    if vi in (0, N_OBS - 1):
        assert float(pout.reg_loss.detach()) != 0.0
    grads_close({k: p.grad for k, p in pm.named_parameters() if p.requires_grad}, jg)


def test_res_dict_tallies_of_an_eager_forward(base):
    jm, jv, pm = base
    x = batch(seed=2)
    for vi, seed in ((3, 1), (3, 2), (1, 3)):
        key = jax.random.PRNGKey(seed)
        jm.forward(jv, jnp.asarray(x), key, vi_index=vi, epoch=5, train=True)
        k_s, _, k_p = jax.random.split(key, 3)
        noise = {"eps": t(np.asarray(jax.random.normal(k_s, (B, LATENT)))),
                 "bridge": t(bridge(k_p, steps_of(vi), (B, LATENT)))}
        with torch.no_grad():
            pm(t(x), noise=noise, vi_index=vi, epoch=5, train=True)
    for vi in range(N_OBS):
        want, got = jm.res_dict[vi], pm.res_dict[vi]
        assert got["count"] == want["count"]
        close(got["rec_loss"], want["rec_loss"], what=f"rec {vi}")
        close(got["reg_loss"], want["reg_loss"], what=f"reg {vi}")
    assert pm.res_dict[3]["count"] == 2


def test_visit_drawn_from_numpys_generator(base):
    jm, jv, pm = base
    np.random.seed(11)
    want = np.random.randint(0, N_OBS)
    np.random.seed(11)
    with torch.no_grad():
        out = pm(t(batch()), epoch=5, generator=torch.Generator().manual_seed(0))
    assert out.vi_index == want and out.recon_x.shape == (B, N_OBS, *INPUT)


def test_reconstruct_oversample_encode_and_forward_simple(base):
    jm, jv, pm = base
    x, key = batch(), jax.random.PRNGKey(4)
    k_e, k_p = jax.random.split(key)
    eps = np.asarray(jax.random.normal(k_e, (B, LATENT)))
    with torch.no_grad():
        for vi in (0, 2):
            want = jax.jit(lambda v: jm.reconstruct(v, jnp.asarray(x), vi, key))(jv)
            got = pm.reconstruct(t(x), vi, noise={"eps": t(eps), "bridge": t(
                bridge(k_p, steps_of(vi), (B, LATENT)))})
            close(got[0], want[0], what="z_seq")
            close(got[1], want[1], what="recon")
        z_fix = np.ones((1, LATENT), np.float32)
        want = jm.reconstruct(jv, jnp.asarray(x[0]), 2, key, z_vi_index=jnp.asarray(z_fix))
        got = pm.reconstruct(t(x[0]), 2, z_vi_index=t(z_fix),
                             noise={"bridge": t(bridge(k_p, steps_of(2), (1, LATENT)))})
        close(got[0], want[0])
        for vi, supp in ((1, 3), (3, 2)):
            want = jax.jit(lambda v: jm.oversample(v, jnp.asarray(x), vi, key,
                                                   num_supp_steps=supp))(jv)
            t_line = np.flip(np.sort(jl.DDIMSampler(jm.ldm, N_OBS - 1 + supp).time_steps))
            match = int(np.argmin(np.abs(t_line - jm.diff_t_steps[vi])))
            got = pm.oversample(t(x), vi, num_supp_steps=supp, noise={
                "eps": t(eps), "bridge": t(bridge(k_p, steps_of(match, len(t_line)),
                                                  (B, LATENT)))})
            assert got[0].shape == (B * (N_OBS - 1 + supp), LATENT)
            close(got[0], want[0], what="oversample z_seq")
            close(got[1], want[1], what="oversample recon")
        eps3 = np.asarray(jax.random.normal(key, (B, N_OBS, LATENT)))
        close(pm.encode(t(x), noise={"eps": t(eps3)}), jm.encode(jv, jnp.asarray(x), key))
        want = jm.forward_simple(jv, jnp.asarray(x), key)
        got = pm.forward_simple(t(x), noise={"eps": t(eps3)})
        for k in ("reconstruction", "z", "mu", "log_var"):
            close(got[k], want[k], what=k)


@pytest.mark.parametrize("freeze", [False, True])
def test_generate(base, freeze, monkeypatch):
    jm, jv, pm = base
    data, key = batch(b=6, seed=3), jax.random.PRNGKey(5)
    n, steps, vi, bs = 5, 4, 3, 3
    want_rec, want_seq = jm.generate(jv, jnp.asarray(data), key, num_gen_seq=n, vi_index=vi,
                                     batch_size=bs, freeze=freeze, num_centroids=3,
                                     mcmc_steps_nbr=steps)
    k_h, key = jax.random.split(key)
    noise = hmc_draws(k_h, 1 if freeze else n, steps, 6)
    noise["bridge"] = []
    for lo in range(0, n, bs):
        key, k_p = jax.random.split(key)
        noise["bridge"].append(bridge(k_p, steps_of(vi), (min(bs, n - lo), LATENT)))
    with torch.no_grad():
        own = pm.generate(t(data), num_gen_seq=n, vi_index=vi, batch_size=bs, freeze=freeze,
                          num_centroids=3, mcmc_steps_nbr=steps, noise=noise)
        # the encodings agree to rounding, but a two-member cluster's medoid
        # is a tie that rounding breaks: the metric is JAX's, from JAX's mu
        _, mu, _ = pm.retrieve_g(t(data[:, vi]), 3, 0.5)
        jmet, jmu, jlv = jm.retrieve_g(jv, jnp.asarray(data[:, vi]), 3, 0.5)
        close(mu, jmu)
        metric = SampledMetric(jmet.centroids, jmet.m_flat, jmet.temperature, jmet.lbd)
        monkeypatch.setattr(pm, "retrieve_g", lambda *a, **k: (metric, t(np.asarray(jmu)),
                                                                t(np.asarray(jlv))))
        rec, seq = pm.generate(t(data), num_gen_seq=n, vi_index=vi, batch_size=bs,
                               freeze=freeze, num_centroids=3, mcmc_steps_nbr=steps,
                               noise=noise)
    assert rec.shape == (n, N_OBS, *INPUT) and seq.shape == (n, N_OBS, LATENT)
    close(seq, want_seq, rtol=1e-4, atol=1e-4, what="z_seq")
    close(rec, want_rec, rtol=1e-4, atol=1e-4, what="recon")
    assert own[0].shape == rec.shape and bool(torch.isfinite(own[0]).all())
    if freeze:
        assert torch.equal(seq[0, vi], seq[-1, vi])


def test_predict_and_get_nll(base):
    jm, jv, pm = base
    x, key = batch(b=2, seed=4), jax.random.PRNGKey(6)
    vi, n, bs = 1, 5, 2
    want = jax.jit(lambda v: jm.predict(v, jnp.asarray(x), vi, key, num_gen_seq=n,
                                        batch_size=bs))(jv)
    draws, k = [], key
    for lo in range(0, n, bs):
        k, k_p = jax.random.split(k)
        draws.append(bridge(k_p, steps_of(vi, future_only=True), (2 * min(bs, n - lo), LATENT)))
    with torch.no_grad():
        got = pm.predict(t(x), vi, num_gen_seq=n, batch_size=bs, noise={"bridge": draws})
    assert got.shape == (2, n, N_OBS - vi - 1, *INPUT)
    close(got, want)
    n_samples, bs = 7, 3  # 7 > 3: two whole batches, the remainder dropped
    want = jm.get_nll(jv, jnp.asarray(x), vi, key, n_samples=n_samples, batch_size=bs)
    n_full, rows = n_samples // bs, bs
    eps, br, k = np.zeros((2, n_full, rows, LATENT), np.float32), [], key
    for i in range(2):
        br.append([])
        for j in range(n_full):
            k, k_e, k_p = jax.random.split(k, 3)
            eps[i, j] = np.asarray(jax.random.normal(k_e, (rows, LATENT)))
            br[i].append(bridge(k_p, steps_of(vi), (rows, LATENT)))
    with torch.no_grad():
        got = pm.get_nll(t(x), vi, n_samples=n_samples, batch_size=bs,
                         noise={"eps": t(eps), "bridge": t(np.asarray(br))})
    assert np.isfinite(got)
    close(got, want, atol=1e-3)
