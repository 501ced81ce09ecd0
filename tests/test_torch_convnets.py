"""The port's CNN and ResNet nets, their Flax-semantics layers and dropout,
against rlvae_tpu.nets and flax.linen on the CPU.

Each net is built narrow (16x16 frames; cnn ``layers`` [4, 8], resnet [8,
16] with ``num_blocks`` [1, 1]; the resnet decoder also at 8x8, where its
seed grid floors at 1 and ``final`` is cropped), given the Flax variables
(``params`` and ``batch_stats``, the BatchNorm ones drawn away from their
init so the eval forward reads them) through
``convert.net_state_from_flax``, and compared in three ways: the eval
forward; the train forward with dropout 0 and the running statistics it
leaves; the gradients of sum(out * w) through the train forward against
``jax.grad``.

Tolerances:
- fp32 policy: outputs and statistics within 1e-5 of max(1, |ref|),
  gradients within 1e-4 of max(1, |ref|) (fp32 sums in another order; the
  convolutions run in IEEE fp32 on both sides).
- bf16 policy: outputs and statistics within 2e-2 of the tensor's largest
  |ref|.  The frameworks round the bf16 convolutions at other places (one
  bf16 step is 2^-8 = 3.9e-3 relative) and a train-mode BatchNorm over 6
  frames magnifies that; measured here: at most 1.3e-2 of the scale (the
  resnet decoder's train output), while JAX's own bf16 net is 1.4e-2 from
  its fp32 one.  bf16 gradients cannot be held to 2e-2 of anything: JAX's
  own bf16 gradients are 2-20% (global relative L2) from its fp32 ones at
  these sizes, and 10-20% per tensor for BatchNorm layers, and the share
  depends on where each backend rounds (XLA on the CPU keeps some fused
  bf16 steps in fp32).  So they are held to the gradients of the same net
  in fp32 (the port's, which the fp32 case holds to JAX's at 1e-4): global
  relative L2 error at most 0.25 (measured 0.014-0.20 over two draws of the
  variables; a dropped gradient path or a wrong layout shows as ~1).

The layers alone: ``Conv`` with XLA's SAME padding at odd and even sizes
(stride 2 on an even size pads (0, 1)), ``ConvTranspose`` SAME at k=3 and
k=4 on odd and even sizes, and BatchNorm's running var (the biased batch
var) against Flax within 1e-6.  Dropout: the identity in eval, about 1-p
kept in train, survivors scaled by 1/(1-p) (bit for bit Flax's on Flax's
own mask), masked gradients, the same generator giving the same masks, and
a replay of recorded masks.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from rlvae_tpu.nets import registry as jreg
from rlvae_tpu_torch.convert import net_state_from_flax
from rlvae_tpu_torch.nets import DropoutMasks, create_decoder, create_encoder
from rlvae_tpu_torch.nets.layers import BatchNorm, Conv, ConvTranspose, dropout

LATENT = 4
NETS = {
    "cnn": {"architecture": "cnn", "layers": [4, 8], "dropout": 0.0},
    "resnet": {"architecture": "resnet", "layers": [8, 16], "num_blocks": [1, 1],
               "dropout": 0.0},
}
# (arch, kind, image size): every net at 16x16, the resnet decoder's crop at 8x8
CASES = [(a, k, 16) for a in NETS for k in ("encoder", "decoder")] + [("resnet", "decoder", 8)]
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (outputs and stats, gradients)
OUT_KEY = {"encoder": ("embedding", "log_covariance"), "decoder": ("reconstruction",)}


def _close(got, want, tol, what, scaled=False):
    """Within tol of max(1, |want|) entry by entry, or (``scaled``) within
    tol of the tensor's largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scaled:
        err = np.abs(got - want) / max(np.abs(want).max(), 1e-12)
    else:
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"{what}: {err.max()} > {tol}"


def _draw(tree, rng):
    """Random values in the shapes of a Flax variables tree: kernels
    N(0, 1/fan_in), biases and running means 0.2 N(0, 1), BatchNorm scales
    and running vars |1 + 0.3 N(0, 1)|, so every leaf shows in the
    comparison."""
    out = {}
    for name, node in tree.items():
        if not hasattr(node, "shape"):
            out[name] = _draw(node, rng)
            continue
        noise = rng.normal(size=node.shape).astype(np.float32)
        if name == "kernel":
            out[name] = (noise / np.sqrt(np.prod(node.shape[:-1]))).astype(np.float32)
        elif name in ("scale", "var"):
            out[name] = np.abs(1.0 + 0.3 * noise).astype(np.float32)
        else:
            out[name] = (0.2 * noise).astype(np.float32)
    return out


def _build(arch, kind, size, dtype):
    cfg = {**NETS[arch], "dtype": dtype}
    shape = (3, size, size)
    make_j, make_p = ((jreg.create_encoder, create_encoder) if kind == "encoder"
                      else (jreg.create_decoder, create_decoder))
    jnet, pnet = make_j(shape, LATENT, cfg), make_p(shape, LATENT, cfg)
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(6, *shape)) if kind == "encoder"
         else rng.normal(size=(6, LATENT))).astype(np.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(1), x)  # traced, not compiled
    params, stats = _draw(shapes["params"], rng), _draw(shapes["batch_stats"], rng)
    pnet.load_state_dict(net_state_from_flax(params, stats))
    return jnet, pnet, params, stats, x


def _jax_apply(jnet, params, stats, x, train):
    return jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                      deterministic=True, train=train,
                      mutable=["batch_stats"] if train else False)


def _weights(kind, batch, pnet):
    rng = np.random.default_rng(2)
    shapes = {"embedding": (batch, LATENT), "log_covariance": (batch, LATENT),
              "reconstruction": (batch, *pnet.input_dim)}
    return {k: rng.normal(size=shapes[k]).astype(np.float32) for k in OUT_KEY[kind]}


def _jax_reference(jnet, params, stats, x, w):
    """One jitted program: the eval output, the train output with the
    statistics it leaves, and the gradients of sum(out * w) through the
    train forward, in the port's layout."""

    def run(params, stats, x):
        evaluated = _jax_apply(jnet, params, stats, x, train=False)

        def loss(p):
            out, mutated = _jax_apply(jnet, p, stats, x, train=True)
            return sum(jnp.sum(out[k] * w[k]) for k in w), (out, mutated["batch_stats"])

        grads, (trained, new_stats) = jax.grad(loss, has_aux=True)(params)
        return evaluated, trained, new_stats, grads

    evaluated, trained, new_stats, grads = jax.tree_util.tree_map(
        np.asarray, jax.jit(run)(params, stats, jnp.asarray(x)))
    return (evaluated, trained, {k: v.numpy() for k, v in net_state_from_flax({}, new_stats).items()},
            {k: v.numpy() for k, v in net_state_from_flax(grads).items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kind,size", CASES, ids=lambda v: str(v))
def test_net_matches_flax(arch, kind, size, dtype):
    tol_out, tol_grad = TOL[dtype]
    scaled = dtype == "bfloat16"
    jnet, pnet, params, stats, x = _build(arch, kind, size, dtype)
    xt = torch.from_numpy(x)
    w = _weights(kind, x.shape[0], pnet)
    evaluated, trained, new_stats, jgrads = _jax_reference(jnet, params, stats, x, w)

    # eval forward: the running statistics
    with torch.no_grad():
        got = pnet(xt)
    for k in OUT_KEY[kind]:
        assert got[k].dtype == torch.float32
        _close(got[k].numpy(), evaluated[k], tol_out, f"eval {k}", scaled)
    if kind == "decoder":
        assert got["reconstruction"].shape == (6, 3, size, size)

    # train forward (dropout 0): batch statistics, the running ones it
    # leaves, and the gradients of sum(out * w)
    pgrads, got = _port_grads(pnet, xt, w)
    for k in OUT_KEY[kind]:
        _close(got[k].detach().numpy(), trained[k], tol_out, f"train {k}", scaled)
    buffers = dict(pnet.named_buffers())
    assert set(new_stats) == set(buffers) and new_stats
    for name, value in new_stats.items():
        _close(buffers[name].numpy(), value, tol_out, f"stat {name}", scaled)
    assert set(pgrads) == set(jgrads)
    if dtype == "float32":
        for name, g in jgrads.items():
            _close(pgrads[name], g, tol_grad, f"grad {name}")
    else:
        # bf16 gradients are noisy on both sides (module docstring): held, in
        # global relative L2, to the same net's fp32 gradients
        pnet32 = _build(arch, kind, size, "float32")[1]
        ref = _port_grads(pnet32, xt, w)[0]
        assert _global_rel(pgrads, ref) <= BF16_GRAD_L2


BF16_GRAD_L2 = 0.25


def _port_grads(pnet, xt, w):
    pnet.zero_grad()
    out = pnet(xt, train=True)
    sum((out[k] * torch.from_numpy(w[k])).sum() for k in w).backward()
    return {n: p.grad.numpy() for n, p in pnet.named_parameters()}, out


def _global_rel(got, want):
    flat = lambda g: np.concatenate([np.asarray(g[n], np.float64).ravel() for n in sorted(want)])
    return float(np.linalg.norm(flat(got) - flat(want)) / np.linalg.norm(flat(want)))


def test_fp32_convolutions_ignore_the_tf32_flags():
    """An fp32 policy runs IEEE fp32 whatever the global flags say, and
    puts them back after the forward and the backward."""
    jnet, pnet, params, stats, x = _build("cnn", "encoder", 16, "float32")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        out = pnet(torch.from_numpy(x), train=True)
        out["embedding"].sum().backward()
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    want = jax.jit(lambda p, s, x: _jax_apply(jnet, p, s, x, train=True)[0])(params, stats, x)
    _close(out["embedding"].detach().numpy(), want["embedding"], 1e-5, "embedding")


# ---------------------------------------------------------------------------
# the padding and BatchNorm traps, layer by layer
# ---------------------------------------------------------------------------


def _flax_layer(module, x_nhwc, seed=0):
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc))
    kernel = np.asarray(v["params"]["kernel"])
    bias = np.random.default_rng(seed).normal(size=v["params"]["bias"].shape).astype(np.float32)
    v = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    return np.asarray(module.apply(v, jnp.asarray(x_nhwc))), {"kernel": kernel, "bias": bias}


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("kernel,stride,padding", [(3, 2, "SAME"), (3, 1, "SAME"),
                                                   (1, 2, "SAME"), (3, 2, ((1, 1), (1, 1))),
                                                   (7, 2, ((3, 3), (3, 3)))])
def test_conv_padding_matches_flax(size, kernel, stride, padding):
    x = np.random.default_rng(3).normal(size=(2, 3, size, size)).astype(np.float32)
    pad = padding if padding == "SAME" else [tuple(p) for p in padding]
    want, p = _flax_layer(fnn.Conv(5, (kernel, kernel), strides=(stride, stride), padding=pad,
                                   dtype=jnp.float32), x.transpose(0, 2, 3, 1))
    layer = Conv(3, 5, kernel, stride, padding, torch.float32)
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in
                           net_state_from_flax({"conv": p}).items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    _close(got, want, 1e-5, "conv")
    if (kernel, stride, padding, size) == (3, 2, "SAME", 8):
        # the trap: symmetric padding 1 is not XLA's (0, 1) here
        with torch.no_grad():
            naive = torch.nn.functional.conv2d(torch.from_numpy(x), layer.weight, layer.bias,
                                               2, 1).numpy().transpose(0, 2, 3, 1)
        assert np.abs(naive - want).max() > 1e-2


@pytest.mark.parametrize("size", [3, 4])
@pytest.mark.parametrize("kernel", [3, 4])
def test_conv_transpose_matches_flax(size, kernel):
    x = np.random.default_rng(4).normal(size=(2, 6, size, size)).astype(np.float32)
    want, p = _flax_layer(fnn.ConvTranspose(5, (kernel, kernel), strides=(2, 2), padding="SAME",
                                            dtype=jnp.float32), x.transpose(0, 2, 3, 1))
    assert want.shape[1:3] == (2 * size, 2 * size)
    layer = ConvTranspose(6, 5, kernel, 2, torch.float32)
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in
                           net_state_from_flax({"deconv_0": p}).items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    _close(got, want, 1e-5, "conv_transpose")


def test_batchnorm_running_var_is_flax_biased_var():
    rng = np.random.default_rng(5)
    x = (3.0 + 2.0 * rng.normal(size=(4, 6, 5, 5))).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x.transpose(0, 2, 3, 1)))
    want, mutated = bn.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])
    layer = BatchNorm(6)
    got = layer(torch.from_numpy(x), train=True)
    _close(got.detach().numpy().transpose(0, 2, 3, 1), want, 1e-5, "train output")
    _close(layer.mean.numpy(), mutated["batch_stats"]["mean"], 1e-6, "running mean")
    _close(layer.var.numpy(), mutated["batch_stats"]["var"], 1e-6, "running var")
    biased = x.astype(np.float64).var(axis=(0, 2, 3))
    np.testing.assert_allclose(layer.var.numpy(), 0.99 + 0.01 * biased, rtol=1e-5)
    unbiased = x.astype(np.float64).var(axis=(0, 2, 3), ddof=1)
    assert np.abs(layer.var.numpy() - (0.99 + 0.01 * unbiased)).min() > 1e-4
    # eval reads the buffers and leaves them
    before = layer.var.clone()
    with torch.no_grad():
        layer(torch.from_numpy(x))
    assert torch.equal(layer.var, before)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_semantics():
    rate = 0.1
    x = torch.from_numpy(np.random.default_rng(6).uniform(0.5, 1.5, size=(64, 512))
                         .astype(np.float32)).requires_grad_(True)
    assert dropout(x, rate, False, None) is x  # eval: the identity, no masks asked for
    gen = torch.Generator().manual_seed(0)
    masks = DropoutMasks(gen, record=True)
    y = dropout(x, rate, True, masks)
    keep = masks.drawn[0]
    frac = float(keep.float().mean())
    assert abs(frac - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / keep.numel())
    assert torch.equal(y[~keep], torch.zeros_like(y[~keep]))
    np.testing.assert_array_equal(y[keep].detach().numpy(),
                                  (x[keep] / np.float32(1 - rate)).detach().numpy())
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.where(keep.numpy(),
                                                           np.float32(1) / np.float32(0.9), 0))
    # the same generator seed gives the same masks; a replay gives the recorded ones
    again = DropoutMasks(torch.Generator().manual_seed(0))
    assert torch.equal(dropout(x, rate, True, again), y)
    assert torch.equal(dropout(x, rate, True, DropoutMasks(replay=masks.drawn)), y)
    other = DropoutMasks(torch.Generator().manual_seed(1), record=True)
    dropout(x, rate, True, other)
    assert not torch.equal(other.drawn[0], keep)
    with pytest.raises(ValueError, match="generator"):
        dropout(x, rate, True, DropoutMasks())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_scaling_is_flax_on_flax_mask(dtype):
    """Flax's dropout on its own mask, and the port's on the same mask: the
    same bits (the keep probability rounded to the activation dtype)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(7).uniform(0.5, 1.5, size=(32, 256)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    want = fnn.Dropout(0.1).apply({}, xj, deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(3)})
    want = np.asarray(want.astype(jnp.float32))
    keep = torch.from_numpy(want != 0)
    got = dropout(torch.from_numpy(x).to(tdt), 0.1, True, DropoutMasks(replay=[keep]))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_train_nets_draw_dropout_masks_in_order():
    """A cnn encoder with dropout 0.1: one mask per conv stage and per head
    layer, in call order; eval draws none."""
    enc = create_encoder((3, 16, 16), LATENT, {"architecture": "cnn", "layers": [4, 8]})
    assert enc.dropout == 0.1  # the registry's default for cnn and resnet
    x = torch.rand(3, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    masks = DropoutMasks(torch.Generator().manual_seed(1), record=True)
    a = enc(x, train=True, masks=masks)
    assert [tuple(m.shape) for m in masks.drawn] == [(3, 4, 8, 8), (3, 8, 4, 4), (3, 512),
                                                     (3, 256)]
    b = enc(x, train=True, masks=DropoutMasks(replay=masks.drawn))
    assert torch.equal(a["embedding"], b["embedding"])
    with torch.no_grad():
        enc(x, masks=DropoutMasks())  # eval never draws
