"""The port's LVAE_GUGUS (``rlvae_tpu_torch.models.research``), every variant,
against the JAX package's on the CPU.

Input 3x8x8, latent 6, n_obs 3, MLP nets 192->32->6 in fp32, flows of 2
MADE blocks 6->16->16->16->12 with their log-sigma output biases set to 0
(near-identity flows: the reference init's -2.0 amplifies rounding in the
density direction, tests/test_torch_research_lvae.py), B=4.  JAX's
variables and its estimated metrics are carried into the port
(``convert.research_state_from_jax``, ``gugus_host_state`` /
``set_gugus_host_state``), and JAX's draws are handed to the port: the
visit posterior's ε, and the HMC chains' momenta and uniforms
(``draw_chain_noise`` of JAX's chain key).  The ``lvaega`` visit-0 draw
is differentiated through its chain on both sides (on the card the port
refuses that: tests/test_torch_kernels.py).

Tolerances: losses and outputs rtol 1e-5 (atol 1e-5), the HMC draws 1e-4
of max(1, |z|) (15 fp32 leapfrog steps per MCMC step), gradients within
1e-4 of each tensor's largest entry (2e-4 through the HMC chain), the
metric estimates rtol 1e-5 (posterior statistics of the same encoder) and
the pushforward metric rtol 1e-4 (two Jacobians through the density
direction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.models.research import LVAE_GUGUS as JaxGUGUS
from rlvae_tpu.models.research.gugus import _wn_materialize_block
from rlvae_tpu.models.research.lldm import SampledMetric as JaxSampledMetric
from rlvae_tpu.samplers.hmc import draw_chain_noise
from rlvae_tpu_torch.convert import gugus_host_state, research_state_from_jax, set_gugus_host_state
from rlvae_tpu_torch.models.research import LVAE_GUGUS, SampledMetric
from rlvae_tpu_torch.models.research.gugus import VARIANT_PRESETS

INPUT, LATENT, N_OBS, B = (3, 8, 8), 6, 3, 4
NET = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
KW = dict(input_dim=INPUT, latent_dim=LATENT, n_obs=N_OBS, warmup=0, hidden_size=16,
          use_riemann_prior=True, hmc_visit0_steps=1, encoder_config=NET, decoder_config=NET)
RTOL, ATOL, GRAD_RTOL, HMC_RTOL, PUSH_RTOL = 1e-5, 1e-5, 1e-4, 1e-4, 1e-4
OUT_KEYS = ("loss", "reconstruction_loss", "reg_loss", "z_seq", "recon_x")


def near_identity(params):
    for flow in params["flows"]:
        for block in flow:
            last = max(int(k[1]) for k in block if k[0] == "b")
            block[f"b{last}"][LATENT:] = 0.0
    return params


def pair(variant, data=None, local=False, **kw):
    """(JAX model, variables, port model) of ``variant``; with ``data`` the
    metric is estimated on the JAX side and carried across."""
    jm = JaxGUGUS(variant=variant, **{**KW, **kw})
    jv = jax.tree_util.tree_map(lambda a: np.array(a), jm.init(jax.random.PRNGKey(0)))
    near_identity(jv["params"])  # weight-normed blocks keep their biases as b<l>
    pm = LVAE_GUGUS(variant=variant, **{**KW, **kw})
    pm.load_state_dict(research_state_from_jax(jv))
    if data is not None:
        if local:
            jm.retrieve_metric_local(jv, jnp.asarray(data), num_centroids=3, knn_neighbors=4)
        else:
            jm.retrieve_metric_all(jv, jnp.asarray(data))
        set_gugus_host_state(pm, gugus_host_state(jm))
    return jm, jv, pm


def batch(b=B, seed=1):
    return np.random.default_rng(seed).uniform(size=(b, N_OBS, *INPUT)).astype(np.float32)


def chain_noise(key, steps, n):
    """JAX's draws of ``sample_prior_hmc(metric, key, ...)``: the chain key
    is split(key)[1]."""
    gammas, unifs = draw_chain_noise(jax.random.split(key)[1], steps, n, LATENT)
    return {"gammas": torch.from_numpy(np.array(gammas)),
            "unifs": torch.from_numpy(np.array(unifs))}


def scaled_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got - want) <= rtol * np.maximum(np.abs(want), 1.0)), \
        np.abs(got - want).max()


@pytest.mark.parametrize("variant", sorted(VARIANT_PRESETS))
def test_visit0_loss_and_gradients(variant):
    """Each preset's visit-0 loss with the Riemannian prior on JAX's
    estimated metric (``lvaegg`` its local metrics), and its gradients;
    ``lvaega2``'s weight-normed flows without its HMC draw, which
    ``lvaega`` differentiates (JAX compiles that gradient for ~10 s)."""
    x = batch()
    kw = {"use_hmc_visit0": False} if variant == "lvaega2" else {}
    jm, jv, pm = pair(variant, data=batch(8, seed=2), local=variant == "lvaegg", **kw)
    key = jax.random.PRNGKey(40)

    def loss(p):
        out = jm.forward({"params": p}, jnp.asarray(x), key, vi_index=0, epoch=10, train=True)
        return out.loss, {k: out[k] for k in OUT_KEYS}

    (_, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    jg = research_state_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    k_s = jax.random.split(key)[0]
    if pm.use_hmc_visit0:
        noise = chain_noise(k_s, pm.hmc_visit0_steps, B)
    else:
        noise = {"eps": torch.from_numpy(np.array(jax.random.normal(k_s, (B, LATENT))))}
    pm.zero_grad()
    pout = pm(torch.from_numpy(x), noise=noise, vi_index=0, epoch=10, train=True)
    pout.loss.backward()
    rtol = HMC_RTOL if pm.use_hmc_visit0 else RTOL
    for k in ("loss", "reconstruction_loss", "reg_loss"):
        np.testing.assert_allclose(pout[k].detach().numpy(), np.asarray(jout[k]), rtol=rtol,
                                   atol=ATOL, err_msg=k)
    scaled_close(pout.z_seq.detach(), jout["z_seq"], rtol)
    grad_rtol = 2 * GRAD_RTOL if pm.use_hmc_visit0 else GRAD_RTOL
    for k, p in pm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(jg[k])
        assert float((g - jg[k]).abs().max()) <= grad_rtol * max(float(jg[k].abs().max()),
                                                                 1e-12), k


def test_metric_estimates_match_jax():
    """retrieve_metric_all (per visit), retrieve_metric_local (k-medoids,
    kNN covariances, temperature, the sampled metric) and the sampled
    metric's G and log pi."""
    data = batch(16, seed=3)
    jm, jv, pm = pair("lvaegg")
    with torch.no_grad():
        gms, gs = pm.retrieve_metric_all(torch.from_numpy(data))
        jgms, jgs = jm.retrieve_metric_all(jv, jnp.asarray(data))
        for a, b in zip(gms + gs, jgms + jgs, strict=True):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7)
        got = pm.retrieve_metric_local(torch.from_numpy(data), num_centroids=4, knn_neighbors=8)
        want = jm.retrieve_metric_local(jv, jnp.asarray(data), num_centroids=4, knn_neighbors=8)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        sm, jsm = pm.sampled_metric, jm.sampled_metric
        np.testing.assert_allclose(sm.centroids.numpy(), np.asarray(jsm.centroids), rtol=RTOL)
        z = np.random.default_rng(4).normal(size=(5, LATENT)).astype(np.float32)
        ref = JaxSampledMetric(np.asarray(jsm.centroids), np.asarray(jsm.m_flat),
                               jsm.temperature, jsm.lbd)
        port = SampledMetric(np.asarray(jsm.centroids), np.asarray(jsm.m_flat), jsm.temperature,
                             jsm.lbd)
        np.testing.assert_allclose(port.g(torch.from_numpy(z)).numpy(),
                                   np.asarray(ref.g(jnp.asarray(z))), rtol=1e-5)
        np.testing.assert_allclose(port.log_pi(torch.from_numpy(z)).numpy(),
                                   np.asarray(ref.log_pi(jnp.asarray(z))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["lvaeg2", "lvaega2"])
def test_metric_field_pushforward_and_compare_metrics(variant):
    """``stored`` serves the per-visit estimates; ``push`` (and beyond the
    stored list) pushes G_0 through the flows (weight-normed for lvaega2);
    compare_metrics's drift."""
    data = batch(8, seed=5)
    jm, jv, pm = pair(variant, data=data)
    z = np.random.default_rng(6).normal(size=(3, LATENT)).astype(np.float32)
    for t in range(N_OBS):
        want = jax.jit(lambda v: jm.metric_tensor_field(v, jnp.asarray(z), t))(jv)
        got = pm.metric_tensor_field(torch.from_numpy(z), t).detach()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PUSH_RTOL, atol=1e-6)
    want = jm.compare_metrics(jv, jnp.asarray(data), t=1)
    got = pm.compare_metrics(torch.from_numpy(data), t=1)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PUSH_RTOL, atol=1e-5, err_msg=k)
    if variant == "lvaega2":
        # the periodic diagnostics hook: every metric_eval_period-th forward
        pm.metric_eval_period = 2
        x = torch.from_numpy(data[:4])
        for i in range(2):
            pm.last_metric_diagnostics = None
            with torch.no_grad():
                pm(x, noise={"eps": torch.zeros(4, LATENT)}, vi_index=1, epoch=10)
            assert (pm.last_metric_diagnostics is not None) == (i == 1)
        assert pm.last_metric_diagnostics == pm.compare_metrics(x, t=0)
        for fi, flow in enumerate(jv["params"]["flows"]):
            for bi, block in enumerate(flow):
                mat = _wn_materialize_block(block)
                for li in range(4):
                    np.testing.assert_allclose(
                        pm.flows[fi].blocks[bi].weight(li).detach().numpy(),
                        np.asarray(mat[f"w{li}"]), rtol=1e-6, atol=1e-7)


def test_generate_hmc_matches_jax():
    """Manifold HMC on the one-centroid metric (20 steps of 15 leapfrogs
    from its centroid), propagated and decoded."""
    jm, jv, pm = pair("lvaeg2", data=batch(8, seed=7))
    key = jax.random.PRNGKey(8)
    want = jax.jit(lambda v: jm.generate_hmc(v, key, 5, vi_index=0))(jv)
    got = pm.generate_hmc(5, vi_index=0, noise=chain_noise(key, 20, 5))
    scaled_close(got, want, HMC_RTOL)
