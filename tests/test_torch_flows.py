"""The port's MADE, IAF, IAF-chain plain version and temporal chain against
rlvae_tpu.flows and the Pallas chain kernel (interpret mode).

Weights come from the port's seeded init and are handed to the JAX side
as numpy.  Tolerances: one MADE pass and one IAF rtol 1e-5 (fp32, same
operations); the chain rtol 1e-4 relative to each transition's largest
|z|: at the reference init every block scales the latent by up to
exp(1.5) per dim, so rounding differences grow with the chain."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.flows import made as jmade
from rlvae_tpu.flows.iaf import iaf_forward as jax_iaf_forward
from rlvae_tpu.flows.iaf import iaf_masks
from rlvae_tpu.flows.temporal import TemporalFlowConfig, apply_temporal_flows as jax_temporal
from rlvae_tpu.ops.iaf_kernels import get_fused_iaf_chain
from rlvae_tpu_torch.flows import IAF, MADE, TemporalFlows, apply_temporal_flows, iaf_forward
from rlvae_tpu_torch.flows.made import make_masks
from rlvae_tpu_torch.ops.iaf_kernels import iaf_chain_fwd, iaf_chain_fwd_ref, stack_chain


def _jax_block(block: MADE):
    out = {}
    for li in range(block.n_layers):
        out[f"w{li}"] = jnp.asarray(block.weights[li].detach().numpy())
        out[f"b{li}"] = jnp.asarray(block.biases[li].detach().numpy())
    return out


def _jax_iaf(iaf: IAF):
    return [_jax_block(b) for b in iaf.blocks]


def _close_scaled(got, want, rtol):
    """|got - want| <= rtol * max|want| per leading index (transition/row)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.max(np.abs(want), axis=tuple(range(1, want.ndim)), keepdims=True)
    np.testing.assert_array_less(np.abs(got - want), np.broadcast_to(rtol * scale + 1e-6, want.shape))


@pytest.mark.parametrize("d,hidden", [(4, [16, 16, 16]), (16, [256, 256, 256]), (5, [7])])
def test_make_masks_equal(d, hidden):
    for a, b in zip(make_masks(d, hidden), jmade.make_masks(d, hidden), strict=True):
        np.testing.assert_array_equal(a, b)


def test_made_pass_and_init_distribution():
    g = torch.Generator().manual_seed(0)
    block = MADE(16, [256, 256, 256], generator=g)
    # init_made's distributions: U(+-1/sqrt(fan_in)); final log_var bias -2.0
    for li, w in enumerate(block.weights):
        bound = 1.0 / np.sqrt(w.shape[0])
        assert float(w.detach().abs().max()) <= bound
    assert torch.all(block.biases[-1][16:] == -2.0)
    x = np.random.default_rng(0).normal(size=(6, 16)).astype(np.float32)
    masks = [jnp.asarray(m) for m in jmade.make_masks(16, [256] * 3)]
    mu_j, lv_j = jmade.made_apply(_jax_block(block), masks, jnp.asarray(x))
    with torch.no_grad():
        mu_t, lv_t = block(torch.from_numpy(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), rtol=1e-5, atol=1e-6)


def test_iaf_forward():
    g = torch.Generator().manual_seed(1)
    iaf = IAF(16, 64, 2, 3, generator=g)
    x = np.random.default_rng(1).normal(size=(5, 16)).astype(np.float32)
    y_j, ld_j = jax_iaf_forward(_jax_iaf(iaf), iaf_masks(16, 64, 3), jnp.asarray(x))
    with torch.no_grad():
        y_t, ld_t = iaf_forward(iaf, torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), rtol=1e-5, atol=1e-5)


def test_chain_ref_vs_pallas_interpret():
    """Small size (D=4, H=16, NB=2, NH=3, NT=3; two flows, the last reused)."""
    D, H, NB, NH, NT = 4, 16, 2, 3, 3
    g = torch.Generator().manual_seed(2)
    flows = [IAF(D, H, NB, NH, generator=g) for _ in range(2)]
    chain = [flows[min(t, 1)] for t in range(NT)]
    x = np.random.default_rng(2).normal(size=(5, D)).astype(np.float32)
    z_j, ld_j = get_fused_iaf_chain(D, H, NB, NH, NT, interpret=True)(
        [_jax_iaf(f) for f in chain], jnp.asarray(x))
    with torch.no_grad():
        z_t, ld_t = iaf_chain_fwd_ref(torch.from_numpy(x), *stack_chain(chain))
    assert z_t.shape == (NT, 5, D) and ld_t.shape == (NT, 5)
    _close_scaled(z_t.numpy(), z_j, 1e-5)
    _close_scaled(ld_t.numpy(), ld_j, 1e-5)


def test_chain_cpu_route_launches_nothing():
    g = torch.Generator().manual_seed(3)
    chain = [IAF(4, 16, 2, 3, generator=g)] * 2
    x = torch.randn(3, 4, generator=g)
    before = iaf_chain_fwd.launches
    with torch.no_grad():
        a = iaf_chain_fwd(x, *stack_chain(chain))
        b = iaf_chain_fwd_ref(x, *stack_chain(chain))
    assert iaf_chain_fwd.launches == before
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def _full_width_flows(log_var_bias_init):
    g = torch.Generator().manual_seed(4)
    flows = TemporalFlows(16, n_flows=8, hidden_size=256, n_blocks=2, n_hidden=3,
                          log_var_bias_init=log_var_bias_init, generator=g)
    x = np.random.default_rng(4).normal(size=(3, 16)).astype(np.float32)
    with torch.no_grad():
        z_t, ld_t = apply_temporal_flows(flows, torch.from_numpy(x), 8)
    assert z_t.shape == (3, 8, 16) and ld_t.shape == (3, 7)
    return flows, x, z_t.numpy(), ld_t.numpy()


def test_temporal_chain_full_width_vs_xla():
    """D=16, H=256, 8 flows, T=8, B=3, with near-identity flows (log_var bias
    0.0, the stable preset's init): the whole chain against the JAX XLA path."""
    flows, x, z_t, ld_t = _full_width_flows(0.0)
    cfg = TemporalFlowConfig(16, n_flows=8, hidden_size=256, n_blocks=2, n_hidden=3,
                             backend="xla", log_var_bias_init=0.0)
    z_j, ld_j = jax_temporal(cfg, [_jax_iaf(f) for f in flows.flows], jnp.asarray(x), 8)
    # leading axis = time step: scale each step by its own largest |z|
    _close_scaled(np.moveaxis(z_t, 1, 0), np.moveaxis(np.asarray(z_j), 1, 0), 1e-4)
    np.testing.assert_allclose(ld_t, np.asarray(ld_j), rtol=1e-4, atol=1e-4)


def test_temporal_chain_reference_init_per_transition():
    """At the reference init (log_var bias -2.0) each block scales the latent
    by up to exp(1.5) per dim, so a chain of 7 transitions amplifies the
    last-bit differences of two fp32 implementations far beyond rounding
    (|z| reaches ~1e7).  Each transition is therefore held against JAX's
    iaf_forward from the port's own input to that transition."""
    flows, _, z_t, ld_t = _full_width_flows(-2.0)
    masks = iaf_masks(16, 256, 3)
    for t in range(7):
        y_j, ld_j = jax_iaf_forward(_jax_iaf(flows.flows[t]), masks, jnp.asarray(z_t[:, t]))
        _close_scaled(z_t[None, :, t + 1], np.asarray(y_j)[None], 1e-4)
        np.testing.assert_allclose(ld_t[:, t], np.asarray(ld_j), rtol=1e-4, atol=1e-4)


def test_unported_options_raise():
    """The Jacobi fixed-point blocks are ported (tests/test_torch_fixedpoint.py):
    a chain with ``fixedpoint_iters=4`` builds and equals JAX's kernel pair
    at fp_iters=4 (interpret mode), and the sampling direction ignores the
    option, as JAX's does; a negative count still raises."""
    with pytest.raises(ValueError):
        TemporalFlows(4, n_flows=1, fixedpoint_iters=-1)
    g = torch.Generator().manual_seed(3)
    flows = TemporalFlows(6, n_flows=1, hidden_size=8, n_blocks=2, n_hidden=2,
                          log_var_bias_init=0.0, fixedpoint_iters=4, generator=g)
    x = np.random.default_rng(3).normal(size=(3, 6)).astype(np.float32)
    z_t, ld_t = apply_temporal_flows(flows, torch.from_numpy(x), 3)
    chain = get_fused_iaf_chain(6, 8, 2, 2, 2, interpret=True, fp_iters=4)
    z_j, ld_j = chain([_jax_iaf(flows.flows[0])] * 2, jnp.asarray(x))
    _close_scaled(np.moveaxis(z_t.detach().numpy()[:, 1:], 1, 0), np.asarray(z_j), 1e-5)
    np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j).T, rtol=1e-5, atol=1e-5)
    sampling = TemporalFlows(6, n_flows=1, hidden_size=8, n_blocks=2, n_hidden=2,
                             direction="sampling", fixedpoint_iters=4, generator=g)
    plain = copy.deepcopy(sampling)
    plain.fixedpoint_iters = 0
    for a_, b_ in zip(apply_temporal_flows(sampling, torch.from_numpy(x), 3),
                      apply_temporal_flows(plain, torch.from_numpy(x), 3)):
        assert torch.equal(a_, b_)
