"""The port's VAMP, VampSampler and the research nets (``SVAEEncoderMLP``,
``DiscriminatorMLP``) against the JAX package's on the CPU.

Small widths: frames 1x16x16, latent 4, 5 pseudo-input components, 3
visits, MLP nets 256->32->4 in fp32 (``dtype: float32``, so both sides run
the same fp32 operations), B=8.  One set of JAX variables
(``init(PRNGKey(0))``) is carried into the port by
``convert.research_state_from_jax`` (VAMP's ``pseudo`` Linear included);
JAX's own draws are handed to the port as ``noise``: the forward's
``normal(key, (B*T, D))``, ``generate``'s ``randint(split(key)[0])`` and
``normal(split(key)[1])``, ``estimate_nll``'s ``normal`` of each of
``split(key, S)``, the sampler's ``randint``/``normal`` of ``split(key)``.
The nets are held to the Flax modules on the same parameters
(``convert.net_state_from_flax``), in fp32 and in their default bf16.

Tolerances: fp32 on both sides, sums in another order: losses, log p(z),
latents and the NLL rtol 1e-5 (atol 1e-5; the NLL atol 1e-3 of a value
~1e2-1e3); reconstructions atol 1e-5; gradients within 1e-4 of each
tensor's largest entry (the backward sums over B*T frames); the bf16 nets
within 2^-7 of the output's scale (one bf16 rounding apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.models.research import VAMP as JaxVAMP
from rlvae_tpu.nets import DiscriminatorMLP as JaxDisc
from rlvae_tpu.nets import SVAEEncoderMLP as JaxSVAE
from rlvae_tpu.samplers.generation import VampSampler as JaxVampSampler
from rlvae_tpu_torch.convert import net_state_from_flax, research_state_from_jax
from rlvae_tpu_torch.models.research import VAMP
from rlvae_tpu_torch.nets import DiscriminatorMLP, SVAEEncoderMLP
from rlvae_tpu_torch.samplers import SAMPLER_REGISTRY, VampSampler

INPUT, LATENT, N_OBS, B, C = (1, 16, 16), 4, 3, 8, 5
NET = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
KW = dict(input_dim=INPUT, latent_dim=LATENT, number_components=C, encoder_config=NET,
          decoder_config=NET)
RTOL, ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
OUT_KEYS = ("loss", "reconstruction_loss", "reg_loss", "z", "recon_x")


def _pair(**kw):
    jm = JaxVAMP(**{**KW, **kw})
    jv = jax.tree_util.tree_map(lambda a: np.array(a), jm.init(jax.random.PRNGKey(0)))
    pm = VAMP(**{**KW, **kw})
    pm.load_state_dict(research_state_from_jax(jv))
    return jm, jv, pm


@pytest.fixture(scope="module")
def mse_pair():
    return _pair(linear_scheduling_steps=4)


def _batch(seed=1):
    return np.random.default_rng(seed).uniform(size=(B, N_OBS, *INPUT)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _grads_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        assert float((got[k] - w).abs().max()) <= GRAD_RTOL * scale, k


@pytest.mark.parametrize("loss_kind,masked", [("mse", False), ("bce", True)])
def test_forward_losses_and_gradients(mse_pair, loss_kind, masked):
    """A train forward in the KL warmup (epoch 2 of 4) and its gradients;
    the BCE case with sequence and pixel masks."""
    jm, jv, pm = mse_pair if loss_kind == "mse" else _pair(reconstruction_loss="bce",
                                                           linear_scheduling_steps=4)
    x, key = _batch(), jax.random.PRNGKey(3)
    kw = dict(epoch=2, train=True)
    pkw = dict(kw)
    if masked:
        rng = np.random.default_rng(2)
        seq = np.ones((B, N_OBS), np.float32)
        seq[:, 1] = 0.0
        pix = (rng.uniform(size=x.shape) > 0.2).astype(np.float32)
        kw.update(seq_mask=jnp.asarray(seq), pix_mask=jnp.asarray(pix))
        pkw.update(seq_mask=torch.from_numpy(seq), pix_mask=torch.from_numpy(pix))

    def loss(p):
        out = jm.forward({"params": p}, jnp.asarray(x), key, **kw)
        return out.loss, {k: out[k] for k in OUT_KEYS}

    (_, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    jg = research_state_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    eps = np.asarray(jax.random.normal(key, (B * N_OBS, LATENT)))
    pm.zero_grad()
    pout = pm(torch.from_numpy(x), noise={"eps": torch.from_numpy(eps)}, **pkw)
    pout.loss.backward()
    for k in ("loss", "reconstruction_loss", "reg_loss", "z"):
        _close(pout[k], jout[k], what=k)
    _close(pout["recon_x"], jout["recon_x"], rtol=0, what="recon_x")
    _grads_close({k: p.grad for k, p in pm.named_parameters()}, jg)


def test_log_p_z_and_pseudo_inputs(mse_pair):
    jm, jv, pm = mse_pair
    z = np.random.default_rng(4).normal(size=(11, LATENT)).astype(np.float32)
    want = jax.jit(lambda p: jm.log_p_z(p, jnp.asarray(z)))(jv["params"])
    with torch.no_grad():
        _close(pm.log_p_z(torch.from_numpy(z)), want)
        _close(pm.pseudo_inputs(), jm.pseudo_inputs(jv["params"]), rtol=0, atol=0)


def test_generate_and_estimate_nll(mse_pair):
    jm, jv, pm = mse_pair
    key, n = jax.random.PRNGKey(6), 7
    want = jax.jit(lambda v: jm.generate(v, key, n))(jv)
    k_c, k_e = jax.random.split(key)
    noise = {"idx": torch.from_numpy(np.asarray(jax.random.randint(k_c, (n,), 0, C))),
             "eps": torch.from_numpy(np.asarray(jax.random.normal(k_e, (n, LATENT))))}
    with torch.no_grad():
        _close(pm.generate(n, noise=noise), want, rtol=0)

    x, s = _batch(5), 4
    want = jax.jit(lambda v: jm.estimate_nll(v, jnp.asarray(x), key, n_samples=s))(jv)
    eps = np.stack([np.asarray(jax.random.normal(k, (B * N_OBS, LATENT)))
                    for k in jax.random.split(key, s)])
    with torch.no_grad():
        got = pm.estimate_nll(torch.from_numpy(x), n_samples=s,
                              noise={"eps": torch.from_numpy(eps)})
    assert got.shape == (B * N_OBS,)
    _close(got, want, atol=1e-3)


def test_vamp_sampler_matches_jax(mse_pair, tmp_path):
    jm, jv, pm = mse_pair
    key, n = jax.random.PRNGKey(8), 9
    want = JaxVampSampler(jm, jv).sample_latents(key, n)
    k_idx, k_eps = jax.random.split(key)
    noise = {"idx": torch.from_numpy(np.asarray(jax.random.randint(k_idx, (n,), 0, C))),
             "eps": torch.from_numpy(np.asarray(jax.random.normal(k_eps, (n, LATENT))))}
    sampler = SAMPLER_REGISTRY["vamp"](pm)
    assert isinstance(sampler, VampSampler)
    with torch.no_grad():
        _close(sampler.sample_latents(n, noise=noise), want)
    gen = sampler.sample(5, batch_size=2, output_dir=tmp_path, seed=3)  # its own draws
    assert gen.shape == (5, *INPUT) and np.isfinite(gen).all()
    assert np.array_equal(np.load(tmp_path / "generated.npz")["images"], gen)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_research_nets_match_flax(dtype):
    x = np.random.default_rng(9).uniform(size=(6, *INPUT)).astype(np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    for jnet, pnet in ((JaxSVAE(INPUT, LATENT, (32,), dtype=jnp.dtype(dtype)),
                        SVAEEncoderMLP(INPUT, LATENT, (32,), dtype=tdt)),
                       (JaxDisc(INPUT, (32,), dtype=jnp.dtype(dtype)),
                        DiscriminatorMLP(INPUT, (32,), dtype=tdt))):
        params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
        pnet.load_state_dict(net_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
        want = jnet.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            got = pnet(torch.from_numpy(x))
        assert set(got) == set(want.keys())
        for k in got:
            w = np.asarray(want[k], np.float32)
            g = got[k].float().numpy()
            assert g.shape == w.shape, k
            assert float(np.abs(g - w).max()) <= tol * max(1.0, float(np.abs(w).max())), k
