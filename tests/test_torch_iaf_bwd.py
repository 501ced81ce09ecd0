"""The IAF-chain backward of the port against JAX: iaf_chain_bwd_ref (the
plain version of csrc/iaf_chain_bwd.cu) against the VJP of the Pallas chain
kernel in interpret mode and against jax.vjp of the XLA temporal flows;
the IAFChain autograd Function against autograd through the plain forward;
the forward's residual ys.

Small sizes (D=4 and 8, H=16 and 32, NB=2, NH=3, NT=3 over two flows, the
last reused).  Weights come from the port's seeded init, cotangents from
numpy, and both sides get the same numbers.  Tolerances, fp32 throughout:
each gradient within 1e-4 of its own largest entry (relative to the
tensor's scale, since the near-identity and reference inits give gradients
from ~1e-3 to ~1e5) -- the port and JAX run the same operations in another
summation order, and at the reference init (log-sigma bias -2.0) the chain
scales its cotangents by up to exp(1.5) per block, which amplifies that
rounding.  The fp64 evaluation of the plain version is held to the fp32 one
at the near-identity init within 1e-5 of each tensor's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.flows.temporal import TemporalFlowConfig, apply_temporal_flows as jax_temporal
from rlvae_tpu.ops.iaf_kernels import get_fused_iaf_chain
from rlvae_tpu_torch.flows import IAF, TemporalFlows, apply_temporal_flows
from rlvae_tpu_torch.ops.iaf_kernels import (
    IAFChain,
    iaf_chain_bwd,
    iaf_chain_bwd_ref,
    iaf_chain_fwd_ref,
    stack_chain,
)

NB, NH, NT, B = 2, 3, 3, 5
RTOL = 1e-4
WEIGHTS = ("w0", "b0", "wh", "bh", "wo", "bo")


def _close_scaled(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


def _jax_block(block):
    out = {}
    for li in range(block.n_layers):
        out[f"w{li}"] = jnp.asarray(block.weights[li].detach().numpy())
        out[f"b{li}"] = jnp.asarray(block.biases[li].detach().numpy())
    return out


def _setup(d, h, bias, seed, kind="plain"):
    g = torch.Generator().manual_seed(seed)
    flows = [IAF(d, h, NB, NH, generator=g, log_var_bias_init=bias) for _ in range(2)]
    with torch.no_grad():
        if kind == "clamp":  # log-sigma pinned at the clamp for many rows and dims
            flows[0].blocks[0].weights[-1].mul_(100.0)
        if kind == "coupled":  # every weight x3: later dims lean hard on earlier ones,
            for f in flows:    # so an adjoint cut short of its sweeps shows
                for w in (w for blk in f.blocks for w in blk.weights):
                    w.mul_(3.0)
    chain = [flows[min(t, 1)] for t in range(NT)]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, d)).astype(np.float32)
    dz = rng.normal(size=(NT, B, d)).astype(np.float32)
    dld = rng.normal(size=(NT, B)).astype(np.float32)
    return flows, chain, x, dz, dld


def _port_bwd(chain, x, dz, dld):
    with torch.no_grad():
        w = stack_chain(chain)
        _, _, ys = iaf_chain_fwd_ref(torch.from_numpy(x), *w, return_ys=True)
        dz0, grads = iaf_chain_bwd_ref(ys, torch.from_numpy(dz), torch.from_numpy(dld), *w)
    return dz0.numpy(), [g.numpy() for g in grads], ys


CASES = [(4, 16, 0.0, 0, "plain"), (8, 32, -2.0, 1, "plain"), (8, 32, 0.0, 2, "clamp"),
         (8, 32, 0.0, 2, "coupled")]
IDS = ["D4H16-near-identity", "D8H32-reference-init", "D8H32-clamp-boundary",
       "D8H32-strong-coupling"]


@pytest.mark.parametrize("d,h,bias,seed,kind", CASES, ids=IDS)
def test_bwd_ref_matches_pallas_vjp(d, h, bias, seed, kind):
    """Against the VJP of the Pallas chain (interpret mode, adj_sweeps = D):
    dz0, and each transition's masked weight gradients."""
    flows, chain, x, dz, dld = _setup(d, h, bias, seed, kind)
    fused = get_fused_iaf_chain(d, h, NB, NH, NT, interpret=True)
    params_chain = [[_jax_block(b) for b in f.blocks] for f in chain]
    _, vjp = jax.vjp(fused, params_chain, jnp.asarray(x))
    d_chain, dx = vjp((jnp.asarray(dz), jnp.asarray(dld)))
    dz0, grads, ys = _port_bwd(chain, x, dz, dld)
    if kind == "clamp":  # both sides of the clamp gate occur at block 0 of transition 0
        with torch.no_grad():
            w0, b0, wh, bh, wo, bo = (t[0, 0] for t in stack_chain(chain))
            a = ys[0, 0] @ w0 + b0
            for li in range(NH - 1):
                a = torch.relu(a @ wh[li] + bh[li])
            saturated = ((a @ wo + bo)[:, d:].abs() >= 1.5).float().mean()
        assert 0.2 < float(saturated) < 0.8, float(saturated)
    _close_scaled(dz0, dx, what="dz0")
    g = dict(zip(WEIGHTS, grads))
    masks = [m.numpy() for m in (chain[0].blocks[0].mask(li) for li in range(NH + 1))]
    for t in range(NT):
        for bi in range(NB):
            want = d_chain[t][bi]
            _close_scaled(masks[0] * g["w0"][t, bi], want["w0"], what=f"w0[{t},{bi}]")
            _close_scaled(g["b0"][t, bi], want["b0"], what=f"b0[{t},{bi}]")
            _close_scaled(masks[NH] * g["wo"][t, bi], want[f"w{NH}"], what=f"wo[{t},{bi}]")
            _close_scaled(g["bo"][t, bi], want[f"b{NH}"], what=f"bo[{t},{bi}]")
            for li in range(1, NH):
                _close_scaled(masks[li] * g["wh"][t, bi, li - 1], want[f"w{li}"],
                              what=f"wh[{t},{bi},{li}]")
                _close_scaled(g["bh"][t, bi, li - 1], want[f"b{li}"], what=f"bh[{t},{bi},{li}]")


@pytest.mark.parametrize("d,h,bias,seed,kind", CASES, ids=IDS)
def test_iafchain_grads_match_xla_temporal(d, h, bias, seed, kind):
    """The whole path of the model: apply_temporal_flows through IAFChain and
    autograd through the weight stacking (masks, the reused flow's summed
    gradient), against jax.vjp of the XLA temporal flows."""
    flows, chain, x, _, _ = _setup(d, h, bias, seed, kind)
    n_obs = NT + 1
    rng = np.random.default_rng(seed + 10)
    dzs = rng.normal(size=(B, n_obs, d)).astype(np.float32)
    dlds = rng.normal(size=(B, NT)).astype(np.float32)
    cfg = TemporalFlowConfig(d, 2, h, NB, NH, backend="xla", log_var_bias_init=bias)
    jflows = [[_jax_block(b) for b in f.blocks] for f in flows]
    _, vjp = jax.vjp(lambda fl, z: jax_temporal(cfg, fl, z, n_obs), jflows, jnp.asarray(x))
    jg_flows, jg_x = vjp((jnp.asarray(dzs), jnp.asarray(dlds)))

    tf = TemporalFlows(d, 2, h, NB, NH, log_var_bias_init=bias)
    tf.flows = torch.nn.ModuleList(flows)
    xt = torch.from_numpy(x).requires_grad_(True)
    z_seq, log_dets = apply_temporal_flows(tf, xt, n_obs)
    ((z_seq * torch.from_numpy(dzs)).sum() + (log_dets * torch.from_numpy(dlds)).sum()).backward()
    _close_scaled(xt.grad.numpy(), jg_x, what="dz0")
    for fi, flow in enumerate(flows):
        for bi, blk in enumerate(flow.blocks):
            for li in range(blk.n_layers):
                _close_scaled(blk.weights[li].grad.numpy(), jg_flows[fi][bi][f"w{li}"],
                              what=f"flow {fi} block {bi} w{li}")
                _close_scaled(blk.biases[li].grad.numpy(), jg_flows[fi][bi][f"b{li}"],
                              what=f"flow {fi} block {bi} b{li}")


@pytest.mark.parametrize("bias", [0.0, -2.0])
def test_iafchain_matches_autograd_through_plain_forward(bias):
    """On the CPU the Function (plain forward, plain adjoint backward) gives
    the gradients of autograd through iaf_chain_fwd_ref itself."""
    flows, chain, x, dz, dld = _setup(8, 32, bias, 3)
    params = [p for f in flows for p in f.parameters()]
    grads = []
    for fn in (IAFChain.apply, iaf_chain_fwd_ref):
        xt = torch.from_numpy(x).requires_grad_(True)
        z, ld = fn(xt, *stack_chain(chain))
        loss = (z * torch.from_numpy(dz)).sum() + (ld * torch.from_numpy(dld)).sum()
        grads.append(torch.autograd.grad(loss, [xt, *params]))
    for a, b in zip(*grads):
        _close_scaled(a.numpy(), b.numpy())


def test_forward_residual_ys():
    """ys[t, b] is block b's output before its flip: flipped, the last block's
    is the transition's z; block 0's is what block 1 reads."""
    _, chain, x, _, _ = _setup(4, 16, -2.0, 4)
    w = stack_chain(chain)
    with torch.no_grad():
        z, ld, ys = iaf_chain_fwd_ref(torch.from_numpy(x), *w, return_ys=True)
        z2, ld2 = iaf_chain_fwd_ref(torch.from_numpy(x), *w)
    assert ys.shape == (NT, NB, B, 4)
    assert torch.equal(z, z2) and torch.equal(ld, ld2)
    assert torch.equal(torch.flip(ys[:, -1], dims=(-1,)), z)
    # feeding block 1 its input (block 0's flipped output) reproduces its output
    with torch.no_grad():
        one = [t[:1, 1:2].contiguous() for t in w]
        z_b1, _, ys_b1 = iaf_chain_fwd_ref(torch.flip(ys[0, 0], dims=(-1,)), *one, return_ys=True)
    torch.testing.assert_close(ys_b1[0, 0], ys[0, 1], rtol=1e-6, atol=1e-6)


def test_bwd_ref_in_float64_agrees_with_float32():
    """The plain version is dtype-generic: the fp64 evaluation that the card's
    kernel is held to at the reference init agrees with fp32 at the
    near-identity init."""
    _, chain, x, dz, dld = _setup(8, 32, 0.0, 5)
    w = stack_chain(chain)
    with torch.no_grad():
        _, _, ys = iaf_chain_fwd_ref(torch.from_numpy(x), *w, return_ys=True)
        out32 = iaf_chain_bwd_ref(ys, torch.from_numpy(dz), torch.from_numpy(dld), *w)
        out64 = iaf_chain_bwd_ref(ys.double(), torch.from_numpy(dz).double(),
                                  torch.from_numpy(dld).double(), *(t.double() for t in w))
    assert out64[0].dtype == torch.float64
    _close_scaled(out32[0].numpy(), out64[0].numpy(), rtol=1e-5)
    for a, b in zip(out32[1], out64[1]):
        _close_scaled(a.numpy(), b.numpy(), rtol=1e-5)


def test_bwd_cpu_route_launches_nothing_and_other_devices_raise():
    _, chain, x, dz, dld = _setup(4, 16, 0.0, 6)
    w = stack_chain(chain)
    with torch.no_grad():
        _, _, ys = iaf_chain_fwd_ref(torch.from_numpy(x), *w, return_ys=True)
        before = iaf_chain_bwd.launches
        a = iaf_chain_bwd(ys, torch.from_numpy(dz), torch.from_numpy(dld), *w)
        b = iaf_chain_bwd_ref(ys, torch.from_numpy(dz), torch.from_numpy(dld), *w)
    assert iaf_chain_bwd.launches == before
    assert torch.equal(a[0], b[0]) and all(torch.equal(u, v) for u, v in zip(a[1], b[1]))
    meta = [t.to("meta") for t in (ys, torch.from_numpy(dz), torch.from_numpy(dld), *w)]
    with pytest.raises(ValueError, match="unsupported device"):
        iaf_chain_bwd(*meta)
    with pytest.raises(ValueError, match="dz has shape"):
        iaf_chain_bwd_ref(ys, torch.from_numpy(dz[:2]), torch.from_numpy(dld), *w)
