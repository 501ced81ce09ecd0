"""The port's LVAE_IAF (``rlvae_tpu_torch.models.research``) against the JAX
package's on the CPU.

Small widths: input 3x8x8, latent 4, n_obs 3, MLP nets 192->32->4 in fp32
(``dtype: float32``, so both sides run the same fp32 operations), IAFs of
2 MADE blocks 4->16->16->16->8 (the posterior IAF 3 blocks of 2 layers),
B=3.  One set of JAX variables (``init(PRNGKey(0))``) is carried into the
port by ``convert.research_state_from_jax``; JAX's own draws are handed to
the port as ``noise`` (module docstring of ``lvae_iaf.py``).  Every prior
(standard, VAMP) and posterior (Gaussian, IAF), the warmup branch and the
visit branch at the first, a middle and the last visit.

The flows' log-sigma output biases are set to 0 (near-identity flows) in
all but one test, which holds the forward at JAX's own -2.0 init: there the
density direction scales |z| by up to e^1.5 per dim and block, so |z|
reaches ~2e4 at visit 0 from the last visit, and the weight gradients of
the decoder, which reads those latents, amplify fp32 rounding far past it.

Tolerances: losses and outputs rtol 1e-5 (atol 1e-5 on values near 0):
fp32 on both sides, sums taken in another order; the latent sequence
within 1e-5 of each visit's largest |z|, at least 1; the reconstruction
atol 1e-3 (at the reference init the decoder's pre-activations are ~1e4,
and a 1e-7 relative rounding difference moves a sigmoid in its middle
range by ~1e-4); gradients within 1e-4 of each tensor's largest entry (the backward sums
over B*T frames); ``estimate_nll`` rtol 1e-5 (atol 1e-4) of a value ~ 1e2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.models.research import LVAE_IAF as JaxLVAE
from rlvae_tpu_torch.convert import research_state_from_jax
from rlvae_tpu_torch.models.research import LVAE_IAF

INPUT, LATENT, N_OBS, B = (3, 8, 8), 4, 3, 3
NET = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
KW = dict(input_dim=INPUT, latent_dim=LATENT, n_obs=N_OBS, warmup=5, hidden_size=16,
          vamp_number_components=5, encoder_config=NET, decoder_config=NET)
RTOL, ATOL, GRAD_RTOL, RECON_ATOL = 1e-5, 1e-5, 1e-4, 1e-3


def near_identity(jv, latent=LATENT):
    """JAX's variables with every flow's log-sigma output bias set to 0 (the
    reference init's -2.0 scales |z| by up to e^1.5 per dim and block in the
    density direction)."""
    for flow in jv["params"]["flows"]:
        for block in flow:
            last = max(int(k[1:]) for k in block if k[0] == "b" and k[1:].isdigit())
            block[f"b{last}"][latent:] = 0.0
    return jv


def pair(cls_j=JaxLVAE, cls_p=LVAE_IAF, reference_init=False, **kw):
    """(JAX model, its variables, the port model carrying them); the flows
    near the identity unless ``reference_init``."""
    jm = cls_j(**{**KW, **kw})
    jv = jax.tree_util.tree_map(lambda a: np.array(a), jm.init(jax.random.PRNGKey(0)))
    if not reference_init:
        jv = near_identity(jv)
    pm = cls_p(**{**KW, **kw})
    pm.load_state_dict(research_state_from_jax(jv))
    return jm, jv, pm


def batch(b=B, seed=1):
    return np.random.default_rng(seed).uniform(size=(b, N_OBS, *INPUT)).astype(np.float32)


def visit_noise(key, shape):
    """JAX's visit-posterior draw: ``normal(split(key)[0], shape)``."""
    return np.asarray(jax.random.normal(jax.random.split(key)[0], shape))


def jax_grads(jm, jv, x, key, **kw):
    """(loss output, gradient state dict in the port's names), from one
    jitted program (JAX compiles it faster than it runs it eagerly)."""
    def loss(p):
        out = jm.forward({"params": p}, jnp.asarray(x), key, **kw)
        return out.loss, {k: out[k] for k in OUT_KEYS}

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    return out, research_state_from_jax(jax.tree_util.tree_map(np.asarray, g))


def jax_forward(jm, jv, x, key, **kw):
    return jax.jit(lambda p: {k: v for k, v in jm.forward(
        {"params": p}, jnp.asarray(x), key, **kw).items() if k in OUT_KEYS})(jv["params"])


def port_grads(pm, x, noise, **kw):
    pm.zero_grad()
    out = pm(torch.from_numpy(x), noise=noise, **kw)
    out.loss.backward()
    return out, {k: p.grad for k, p in pm.named_parameters()}


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def grads_close(got, want, rtol=GRAD_RTOL):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k] if got[k] is not None else torch.zeros_like(w)
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max())
        assert err <= rtol * scale, (k, err, scale)


def seq_close(got, want, rtol=RTOL):
    """|got - want| <= rtol * max(1, max|want|) per visit (axis 1)."""
    got, want = np.asarray(got.detach()), np.asarray(want)
    scale = np.maximum(np.abs(want).max(axis=(0, 2), keepdims=True), 1.0)
    assert np.all(np.abs(got - want) <= rtol * scale), np.abs(got - want).max(axis=(0, 2))


OUT_KEYS = ("loss", "reconstruction_loss", "reg_loss", "z_seq", "recon_x")


def outputs_close(pout, jout):
    for k in ("loss", "reconstruction_loss", "reg_loss"):
        close(pout[k], jout[k], what=k)
    seq_close(pout["z_seq"], jout["z_seq"])
    close(pout["recon_x"], jout["recon_x"], atol=RECON_ATOL, what="recon_x")


# every prior and posterior, the first, middle and last visit
VISIT_CASES = [("standard", "gaussian", N_OBS - 1), ("standard", "iaf", 0),
               ("vamp", "gaussian", 1), ("vamp", "iaf", N_OBS - 1)]


@pytest.mark.parametrize("prior,posterior,vi", VISIT_CASES)
def test_visit_branch_loss_and_gradients(prior, posterior, vi):
    jm, jv, pm = pair(prior=prior, posterior=posterior)
    x, key = batch(), jax.random.PRNGKey(10 + vi)
    jout, jg = jax_grads(jm, jv, x, key, vi_index=vi, epoch=10, train=True)
    eps = visit_noise(key, (B, LATENT))
    pout, pg = port_grads(pm, x, {"eps": torch.from_numpy(eps)}, vi_index=vi, epoch=10,
                          train=True)
    outputs_close(pout, jout)
    grads_close(pg, jg)


@pytest.mark.parametrize("vi", [N_OBS - 1])
def test_visit_branch_at_the_reference_flow_init(vi):
    """The flows at JAX's own init: from the last visit the density direction
    takes |z| far from 1 at visit 0; losses and the latent sequence agree."""
    jm, jv, pm = pair(reference_init=True, posterior="iaf")
    x, key = batch(), jax.random.PRNGKey(20 + vi)
    jout = jax_forward(jm, jv, x, key, vi_index=vi, epoch=10, train=True)
    with torch.no_grad():
        pout = pm(torch.from_numpy(x), noise={"eps": torch.from_numpy(visit_noise(key, (B, LATENT)))},
                  vi_index=vi, epoch=10, train=True)
    outputs_close(pout, jout)


@pytest.mark.parametrize("posterior", ["iaf"])
def test_warmup_branch_loss_and_gradients(posterior):
    jm, jv, pm = pair(posterior=posterior, prior="vamp", linear_scheduling_steps=4)
    x, key = batch(), jax.random.PRNGKey(3)
    jout, jg = jax_grads(jm, jv, x, key, epoch=2, train=True)
    eps = np.asarray(jax.random.normal(key, (B * N_OBS, LATENT)))
    pout, pg = port_grads(pm, x, {"eps": torch.from_numpy(eps)}, epoch=2, train=True)
    outputs_close(pout, jout)
    grads_close(pg, jg)


def test_masks_and_beta_schedule():
    """seq and pixel masks, linear beta scheduling in the visit branch."""
    jm, jv, pm = pair(linear_scheduling_steps=20, posterior="iaf")
    x, key = batch(), jax.random.PRNGKey(4)
    rng = np.random.default_rng(2)
    seq = np.ones((B, N_OBS), np.float32)
    seq[:, 1] = 0.0
    pix = (rng.uniform(size=x.shape) > 0.2).astype(np.float32)
    jout = jax_forward(jm, jv, x, key, vi_index=2, epoch=7, train=True,
                       seq_mask=jnp.asarray(seq), pix_mask=jnp.asarray(pix))
    pout = pm(torch.from_numpy(x), noise={"eps": torch.from_numpy(visit_noise(key, (B, LATENT)))},
              vi_index=2, epoch=7, train=True, seq_mask=torch.from_numpy(seq),
              pix_mask=torch.from_numpy(pix))
    outputs_close(pout, jout)


@pytest.mark.parametrize("posterior", ["iaf"])
def test_estimate_nll_matches_jax(posterior):
    jm, jv, pm = pair(posterior=posterior, prior="vamp")
    x, key = batch(), jax.random.PRNGKey(5)
    n, chunk = 7, 3
    want = jax.jit(lambda v: jm.estimate_nll(v, jnp.asarray(x), key, n_samples=n, vi_index=1,
                                             batch_size=chunk))(jv)
    eps, k = [], key
    for s in (3, 3, 1):  # JAX's chunks: split the key, then split the chunk key
        k, k_chunk = jax.random.split(k)
        eps.append(np.asarray(jax.random.normal(jax.random.split(k_chunk)[0], (s, B, LATENT))))
    with torch.no_grad():
        got = pm.estimate_nll(torch.from_numpy(x), n_samples=n, vi_index=1, batch_size=chunk,
                              noise={"eps": torch.from_numpy(np.concatenate(eps))})
    close(got, want, rtol=1e-5, atol=1e-4)


def test_reconstruct_generate_and_infer_missing_match_jax():
    jm, jv, pm = pair(posterior="iaf")
    x = batch()
    with torch.no_grad():
        for vi in (0, 1):
            close(pm.reconstruct(torch.from_numpy(x), vi),
                  jax.jit(lambda v: jm.reconstruct(v, jnp.asarray(x), vi, None))(jv),
                  what="reconstruct")
        key = jax.random.PRNGKey(6)
        z = np.asarray(jax.random.normal(key, (5, LATENT)))
        close(pm.generate(5, vi_index=1, noise={"z": torch.from_numpy(z)}),
              jax.jit(lambda v: jm.generate(v, key, 5, vi_index=1))(jv), what="generate")
        seq = np.ones((B, N_OBS), np.float32)
        seq[:, 1] = 0.0
        pix = np.ones_like(x)
        key = jax.random.PRNGKey(7)
        want = jm.infer_missing(jv, jnp.asarray(x), jnp.asarray(seq), jnp.asarray(pix), key)
        eps, k = [], key
        for _ in range(N_OBS - 1):  # one draw per observed visit
            k, sub = jax.random.split(k)
            eps.append(np.asarray(jax.random.normal(sub, (B, LATENT))))
        got = pm.infer_missing(torch.from_numpy(x), torch.from_numpy(seq), torch.from_numpy(pix),
                               noise={"eps": torch.from_numpy(np.stack(eps))})
        close(got, want, what="infer_missing")
