"""The port's decode+MSE (rlvae_tpu_torch/ops/recon_kernels.py) against the
JAX package's ``decode_mse`` kernel in interpret mode and its XLA reference.

Inputs are ``tests/test_recon_kernels.py``'s problem (h [M, 64], W, b, x,
rw from a numpy seed).  The JAX kernel runs as its own tests run it,
``decode_mse(h, w, b, x, rw, 16, 128, True)``: the loss at (M, N) = (40,
300), (16, 128) and (33, 257) with h in bf16 (the model's decoder), the
gradients at (40, 300) with h in bf16 and in fp32 (JAX's own test); each
JAX reference is evaluated once per module (cached).  The port takes W in
its ``nn.Linear`` layout [N, K], so it gets the transpose.

Tolerances and why:
- loss, plain version vs the interpret-mode kernel: rtol 1e-5 (the same
  bf16-rounded operands, fp32 sums in another order).
- gradients vs ``jax.grad`` of the interpret-mode kernel: max |delta| <=
  1e-3 * max |ref| for dh, dW and db.  The fp32 pre-activation is summed in
  another order, so the bf16 rounding of dp may flip in a few elements; the
  count of differing elements is printed.
- loss and gradients vs the fp32 ``decode_mse_xla``: JAX's own 2e-3 (loss)
  and 1e-2 (gradients, of max |ref|), from the bf16 operands.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.ops.recon_kernels import decode_mse as jax_decode_mse
from rlvae_tpu.ops.recon_kernels import decode_mse_xla
from rlvae_tpu_torch.ops import recon_kernels
from rlvae_tpu_torch.ops.recon_kernels import (
    DecodeMSE,
    decode_mse,
    decode_mse_bwd_dh,
    decode_mse_bwd_dw,
    decode_mse_dh_ref,
    decode_mse_dw_ref,
    decode_mse_ref,
)

SHAPES = [(40, 300), (16, 128), (33, 257)]
H_DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _problem(m=40, h=64, n=300, seed=0):
    """tests/test_recon_kernels.py::_problem, as numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(m, h)).astype(np.float32),
        (rng.normal(size=(h, n)) * 0.1).astype(np.float32),
        (rng.normal(size=(n,)) * 0.1).astype(np.float32),
        rng.uniform(size=(m, n)).astype(np.float32),
        rng.uniform(0.5, 2.0, size=(m,)).astype(np.float32),
    )


def _jax_args(m, n, hdt="fp32"):
    h, w, b, x, rw = _problem(m=m, n=n)
    return (jnp.asarray(h, H_DTYPES[hdt][0]), jnp.asarray(w), jnp.asarray(b), jnp.asarray(x),
            jnp.asarray(rw))


@functools.lru_cache(maxsize=None)
def _jax_loss(m, n):
    """(interpret-mode kernel, XLA reference) losses, bf16 h."""
    args = _jax_args(m, n, "bf16")
    return float(jax_decode_mse(*args, 16, 128, True)), float(decode_mse_xla(*args))


@functools.lru_cache(maxsize=None)
def _jax_grads(hdt, m=40, n=300):
    """(loss, (dh, dW [K, N], db)) of the interpret-mode kernel and the
    (dh, dW, db) of the XLA reference, numpy."""
    h, w, b, x, rw = _jax_args(m, n, hdt)
    loss, grads = jax.value_and_grad(
        lambda h_, w_, b_: jax_decode_mse(h_, w_, b_, x, rw, 16, 128, True),
        argnums=(0, 1, 2))(h, w, b)
    xla = jax.grad(lambda h_, w_, b_: decode_mse_xla(h_, w_, b_, x, rw), argnums=(0, 1, 2))(
        h.astype(jnp.float32), w, b)
    return (float(loss), tuple(np.asarray(g, np.float32) for g in grads),
            tuple(np.asarray(g) for g in xla))


def _port(m, n, hdt, rw_override=None):
    """The port's (loss, (dh, dW^T, db)) through DecodeMSE on the CPU."""
    h, w, b, x, rw = _problem(m=m, n=n)
    if rw_override is not None:
        rw = rw_override
    ht = torch.tensor(h).to(H_DTYPES[hdt][1]).requires_grad_(True)
    wt = torch.tensor(w.T).requires_grad_(True)
    bt = torch.tensor(b).requires_grad_(True)
    loss = DecodeMSE.apply(ht, wt, bt, torch.tensor(x), torch.tensor(rw))
    loss.backward()
    grads = (ht.grad.float().numpy(), wt.grad.numpy().T, bt.grad.numpy())
    return float(loss.detach()), grads


@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_loss_matches_the_interpret_kernel(m, n):
    h, w, b, x, rw = (torch.tensor(a) for a in _problem(m=m, n=n))
    got = float(decode_mse_ref(h.to(torch.bfloat16), w.T, b, x, rw))
    want, ref = _jax_loss(m, n)
    assert abs(got - want) <= 1e-5 * abs(want)
    assert abs(got - ref) <= 2e-3 * abs(ref)
    assert float(DecodeMSE.apply(h.to(torch.bfloat16), w.T, b, x, rw)) == got


@pytest.mark.parametrize("hdt", sorted(H_DTYPES))
def test_gradients_match_the_interpret_kernel(hdt):
    m, n = SHAPES[0]
    loss, got = _port(m, n, hdt)
    want_loss, want, ref = _jax_grads(hdt)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for name, a, b in zip(("dh", "dW", "db"), got, want):
        assert a.shape == b.shape, name
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        print(f"{name} ({m}x{n}, h {hdt}): {int((a != b).sum())} of {a.size} differ, "
              f"max |delta| {err:.3g} of scale {scale:.3g}")
        assert err <= 1e-3 * scale, name
    for name, a, b in zip(("dh", "dW", "db"), got, ref):
        assert float(np.abs(a - b).max()) <= 1e-2 * float(np.abs(b).max()), name


@pytest.mark.parametrize("hdt", sorted(H_DTYPES))
def test_zero_weight_rows_drop_out(hdt):
    """A row with rw = 0 adds nothing to the loss and gets an exactly zero
    dh row (tests/test_recon_kernels.py::test_zero_row_weights_drop_rows)."""
    h, w, b, x, rw = _problem()
    rw0 = rw.copy()
    rw0[7] = 0.0
    loss, (dh, _, _) = _port(40, 300, hdt, rw_override=rw0)
    keep = np.arange(40) != 7
    t = lambda a: torch.tensor(a)  # noqa: E731
    dropped = float(decode_mse_ref(t(h[keep]).to(H_DTYPES[hdt][1]), t(w.T), t(b), t(x[keep]),
                                   t(rw[keep])))
    assert abs(loss - dropped) <= 1e-6 * abs(dropped)
    assert np.all(dh[7] == 0.0) and np.any(dh[keep] != 0.0)


def test_wrappers_are_the_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing; the backward's dh is rounded to bf16 for a bf16 h and
    scaled by the cotangent after the rounding."""
    h, w, b, x, rw = (torch.tensor(a) for a in _problem(m=16, n=128))
    hb, w = h.to(torch.bfloat16), w.T.contiguous()
    g = torch.tensor(3.0)
    before = (decode_mse.launches, decode_mse_bwd_dh.launches, decode_mse_bwd_dw.launches)
    assert torch.equal(decode_mse(hb, w, b, x, rw), decode_mse_ref(hb, w, b, x, rw))
    dh = decode_mse_bwd_dh(hb, w, b, x, rw, g)
    assert dh.dtype == torch.bfloat16 and torch.equal(dh, decode_mse_dh_ref(hb, w, b, x, rw, g))
    assert torch.equal(dh, (3.0 * decode_mse_dh_ref(hb, w, b, x, rw, torch.tensor(1.0)).float())
                       .to(torch.bfloat16))
    dw, db = decode_mse_bwd_dw(hb, w, b, x, rw, g)
    dw1, db1 = decode_mse_dw_ref(hb, w, b, x, rw, torch.tensor(1.0))
    torch.testing.assert_close(dw, 3.0 * dw1, rtol=1e-6, atol=0)
    torch.testing.assert_close(db, 3.0 * db1, rtol=1e-6, atol=0)
    assert decode_mse_bwd_dh(h, w, b, x, rw, g).dtype == torch.float32
    after = (decode_mse.launches, decode_mse_bwd_dh.launches, decode_mse_bwd_dw.launches)
    assert after == before


def test_fp64_plain_version_rounds_the_same_operands():
    """fp64 targets give the fp64 evaluation of the same bf16-rounded
    operands (the card's reference for the forward), within fp32 rounding
    of the fp32 plain version."""
    h, w, b, x, rw = (torch.tensor(a) for a in _problem())
    w = w.T.contiguous()
    loss32 = decode_mse_ref(h, w, b, x, rw)
    loss64 = decode_mse_ref(h, w.double(), b.double(), x.double(), rw.double())
    assert loss64.dtype == torch.float64
    assert abs(float(loss32) - float(loss64)) <= 1e-6 * abs(float(loss64))


def test_kernel_wrappers_refuse_other_devices_and_bad_shapes():
    """A tensor on neither the CPU nor the card is refused, and so is a
    shape that does not fit (meta tensors, no card needed)."""
    meta = dict(device="meta")
    h = torch.empty((4, 600), dtype=torch.bfloat16, **meta)
    w, b = torch.empty((8, 600), **meta), torch.empty((8,), **meta)
    x, rw = torch.empty((4, 8), **meta), torch.empty((4,), **meta)
    for wrapper, args in ((decode_mse, ()), (decode_mse_bwd_dh, (torch.empty((), **meta),)),
                          (decode_mse_bwd_dw, (torch.empty((), **meta),))):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(h, w, b, x, rw, *args)
    with pytest.raises(ValueError, match="expected"):
        recon_kernels._shapes("decode_mse", h, w, b, x[:, :7], rw)
