"""The port's MLP encoder and decoder against rlvae_tpu.nets.mlp, both
loaded from data/pretrained/{encoder,decoder}.npz.

Tolerances: with ``dtype: float32`` on both sides, rtol 1e-5 and atol 1e-5
(fp32 products of length up to 12288 summed in another order).  At the
default bf16 activations, rtol 1e-2 and atol 1e-2: the two frameworks
round the bf16 products and bias adds at different places, and bf16 keeps
8 bits (a relative step of 2^-8 ~ 4e-3 per rounding)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.data.convert import load_component_npz as jax_load_npz
from rlvae_tpu.nets.mlp import MLPDecoder as JaxDecoder
from rlvae_tpu.nets.mlp import MLPEncoder as JaxEncoder
from rlvae_tpu_torch.convert import load_pretrained_net
from rlvae_tpu_torch.nets import create_decoder, create_encoder

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
SHAPE = (3, 64, 64)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture(scope="module")
def npz():
    return {k: jax_load_npz(DATA / f"{k}.npz")["params"] for k in ("encoder", "decoder")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_encoder(npz, dtype):
    x = np.random.default_rng(0).uniform(size=(4, *SHAPE)).astype(np.float32)
    jenc = JaxEncoder(input_dim=SHAPE, latent_dim=16, dtype=getattr(jnp, dtype))
    want = jenc.apply({"params": npz["encoder"]}, jnp.asarray(x))
    enc = create_encoder(SHAPE, 16, {"architecture": "mlp", "dtype": dtype})
    load_pretrained_net(enc, DATA / "encoder.npz")
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    for key in ("embedding", "log_covariance"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_decoder(npz, dtype):
    z = np.random.default_rng(1).normal(size=(5, 16)).astype(np.float32)
    jdec = JaxDecoder(input_dim=SHAPE, latent_dim=16, dtype=getattr(jnp, dtype))
    want = jdec.apply({"params": npz["decoder"]}, jnp.asarray(z)).reconstruction
    dec = create_decoder(SHAPE, 16, {"architecture": "mlp", "dtype": dtype})
    load_pretrained_net(dec, DATA / "decoder.npz")
    with torch.no_grad():
        got = dec(torch.from_numpy(z))["reconstruction"]
    assert got.shape == (5, *SHAPE) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("arch", ["mlp", "cnn", "resnet"])
def test_every_architecture_builds(arch):
    """Each registry architecture builds at the full width with its defaults
    (cnn and resnet: dropout 0.1) and runs a frame; the MLP artifacts do
    not fit the conv nets, nor a narrower MLP."""
    enc = create_encoder(SHAPE, 16, {"architecture": arch})
    dec = create_decoder(SHAPE, 16, {"architecture": arch})
    assert enc.dropout == dec.dropout == (0.0 if arch == "mlp" else 0.1)
    with torch.no_grad():
        mu = enc(torch.zeros(1, *SHAPE))["embedding"]
        assert dec(mu)["reconstruction"].shape == (1, *SHAPE)
    if arch != "mlp":
        with pytest.raises(ValueError):
            load_pretrained_net(enc, DATA / "encoder.npz")
    with pytest.raises(ValueError):
        load_pretrained_net(create_encoder((3, 8, 8), 16), DATA / "encoder.npz")


def test_unknown_architecture_raises():
    with pytest.raises(ValueError, match="Unknown architecture"):
        create_encoder(SHAPE, 16, {"architecture": "transformer"})


def test_decoder_without_hidden_layers_rounds_the_latent_as_jax():
    """With ``hidden_dims=[]`` JAX's decoder still casts z to ``dtype`` before
    the output layer (``z.astype(self.dtype)``), so a bf16 decoder rounds the
    latent; the port's ``MLPDecoder.hidden`` does the same.  Output layer in
    fp32 on both sides, so the comparison is at fp32 tolerance."""
    import jax

    shape = (3, 4, 4)
    z = np.random.default_rng(2).normal(size=(6, 16)).astype(np.float32)
    jdec = JaxDecoder(input_dim=shape, latent_dim=16, hidden_dims=(), dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, jdec.init(jax.random.PRNGKey(0), jnp.asarray(z)))
    want = np.asarray(jdec.apply(params, jnp.asarray(z)).reconstruction)
    dec = create_decoder(shape, 16, {"architecture": "mlp", "hidden_dims": [], "dtype": "bfloat16"})
    out = params["params"]["out"]
    with torch.no_grad():
        dec.out.weight.copy_(torch.from_numpy(out["kernel"].T))
        dec.out.bias.copy_(torch.from_numpy(out["bias"]))
        got = dec(torch.from_numpy(z))["reconstruction"].numpy()
        unrounded = torch.sigmoid(dec.out(torch.from_numpy(z))).numpy().reshape(got.shape)
    np.testing.assert_allclose(got, want, **TOL["float32"])
    assert np.abs(unrounded - want).max() > 1e-4  # the rounding of z shows
