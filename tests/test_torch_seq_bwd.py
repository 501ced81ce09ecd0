"""The sequential mode of the IAF-chain backward (``n_sweeps = 0``, JAX's
``adj_sweeps = 0``) against the JAX package on the CPU.

- The plain chain VJP in the sequential mode (``IAFChain`` on CPU tensors
  under ``ADJ_SWEEPS_OVERRIDE = 0``: dz0 and the six weight gradients,
  through the stacking autograd that applies the masks and sums a reused
  flow's gradients) against JAX's kernel pair ``get_fused_iaf_chain(...,
  interpret=True, adj_sweeps=0)``, whose backward is
  ``_transition_bwd_body``; D=6, H=16, 2 blocks of 3 hidden layers, 3
  transitions over 2 flows, B=5, at the near-identity flow init (log-sigma
  bias 0), as JAX's own test of the mode.  At the reference init (bias
  -2) the chain's gradient is ill-conditioned in its residuals: the plain
  version's dz0 from its own fp32 residuals lies 2.1e-5 of scale from an
  fp64 evaluation in either mode (1.1e-6 from the fp64 residuals), so
  there the two modes are held to each other on the same residuals.
- The sequential mode against the adjoint mode of the same plain version on
  the same inputs, at both inits: equal after the masks up to fp32 order
  (the raw gradients differ where the masks zero them).
- A tiny default-model train step under the override against JAX's model
  on the kernel pair with JAX's override at 0.
- ``_check_sweeps`` rejecting negatives, and the sequential mode without z0.

Tolerances: fp32 on both sides, the same operations in another order: each
gradient within rtol 1e-5 and atol 1e-6 x its largest entry (JAX's own
test of the two modes, ``tests/test_iaf_kernels.py:195-217``); the model's
losses rtol 1e-4 (atol 1e-5), parameters after the steps atol 2e-5 (2% of
one Adam step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlvae_tpu.ops.iaf_kernels as jax_iaf_kernels
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.models.rlvae import RlVAE as JaxRlVAE
from rlvae_tpu.ops.iaf_kernels import get_fused_iaf_chain
from rlvae_tpu.train import optim as jopt
from rlvae_tpu.train.trainer import make_train_step as jax_make_train_step
from rlvae_tpu_torch.convert import from_jax_variables, params_to_numpy
from rlvae_tpu_torch.flows import TemporalFlows
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.models.rlvae import RlVAE
from rlvae_tpu_torch.ops import iaf_kernels as ik
from rlvae_tpu_torch.train import make_optimizer, make_train_step

D, H, NB, NH, NT, B = 6, 16, 2, 3, 3, 5
RTOL = 1e-5
LR, WD = 1e-3, 1e-4
LOSS_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty", "grad_norm")


def _jax_block(block):
    return {f"{k}{li}": jnp.asarray(getattr(block, "weights" if k == "w" else "biases")[li]
                                    .detach().numpy())
            for k in "wb" for li in range(block.n_layers)}


def _chain(bias):
    g = torch.Generator().manual_seed(0)
    flows = TemporalFlows(D, 2, H, NB, NH, log_var_bias_init=bias, generator=g)
    return flows, [flows.flows[min(t, 1)] for t in range(NT)]


def _close(got, want):
    """rtol 1e-5, atol 1e-6 x the largest |want| (the JAX test's tolerance)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * max(float(np.abs(want).max()), 1e-30))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(NT, B, D)).astype(np.float32),
            rng.normal(size=(NT, B)).astype(np.float32))


def _port_vjp(flows, chain, z0, dz, dld):
    """(z, ld, dz0, {param: grad}) through IAFChain and the stacking autograd."""
    flows.zero_grad(set_to_none=True)
    zt = torch.from_numpy(z0).requires_grad_(True)
    z, ld = ik.IAFChain.apply(zt, *ik.stack_chain(chain), 0)
    ((z * torch.from_numpy(dz)).sum() + (ld * torch.from_numpy(dld)).sum()).backward()
    return z.detach(), ld.detach(), zt.grad, {n: p.grad.clone()
                                               for n, p in flows.named_parameters()}


@pytest.mark.parametrize("seed", [1, 4])
def test_plain_sequential_vjp_matches_the_interpret_kernel(seed, monkeypatch):
    flows, chain = _chain(0.0)
    jchain = [[_jax_block(b) for b in iaf.blocks] for iaf in chain]
    z0, dz, dld = _inputs(seed)
    f = get_fused_iaf_chain(D, H, NB, NH, NT, interpret=True, adj_sweeps=0)
    _, vjp = jax.vjp(f, jchain, jnp.asarray(z0))
    g_chain, g_z0 = vjp((jnp.asarray(dz), jnp.asarray(dld)))

    monkeypatch.setattr(ik, "ADJ_SWEEPS_OVERRIDE", 0)
    _, _, dz0, grads = _port_vjp(flows, chain, z0, dz, dld)
    _close(dz0, g_z0)
    for fi, iaf in enumerate(flows.flows):
        uses = [t for t in range(NT) if min(t, 1) == fi]
        for bi, block in enumerate(iaf.blocks):
            for kind, field in (("w", "weights"), ("b", "biases")):
                for li in range(block.n_layers):
                    want = sum(np.asarray(g_chain[t][bi][f"{kind}{li}"]) for t in uses)
                    _close(grads[f"flows.{fi}.blocks.{bi}.{field}.{li}"], want)


@pytest.mark.parametrize("bias", [0.0, -2.0])
def test_sequential_mode_equals_the_adjoint_mode_after_the_masks(bias, monkeypatch):
    """Same inputs through both modes of the plain version: dz0 and every
    (masked) parameter gradient agree; the raw stacked gradients do not,
    where the masks zero them."""
    flows, chain = _chain(bias)
    z0, dz, dld = _inputs(2)
    monkeypatch.setattr(ik, "ADJ_SWEEPS_OVERRIDE", 0)
    z_s, ld_s, dz0_s, g_s = _port_vjp(flows, chain, z0, dz, dld)
    monkeypatch.setattr(ik, "ADJ_SWEEPS_OVERRIDE", None)  # auto: D adjoint sweeps
    z_a, ld_a, dz0_a, g_a = _port_vjp(flows, chain, z0, dz, dld)
    assert torch.equal(z_s, z_a) and torch.equal(ld_s, ld_a)
    _close(dz0_s, dz0_a)
    for name in g_a:
        _close(g_s[name], g_a[name])

    w = [x.detach() for x in ik.stack_chain(chain)]
    _, _, ys = ik.iaf_chain_fwd_ref(torch.from_numpy(z0), *w, return_ys=True)
    args = (ys, torch.from_numpy(dz), torch.from_numpy(dld), *w)
    _, raw_s = ik.iaf_chain_bwd_ref(*args, n_sweeps=0, z0=torch.from_numpy(z0))
    _, raw_a = ik.iaf_chain_bwd_ref(*args, n_sweeps=D)
    assert not torch.allclose(raw_s[0], raw_a[0], rtol=1e-3, atol=1e-3)  # unmasked entries
    mask0 = (w[0] != 0).to(torch.float32)  # W0's MADE mask, as stacked
    _close(raw_s[0] * mask0, raw_a[0] * mask0)


def _metric_arrays(k=8, d=D, seed=0):
    rng = np.random.default_rng(seed)
    c = (0.5 * rng.normal(size=(k, d))).astype(np.float32)
    a = (rng.normal(size=(k, d, d)) / np.sqrt(d)).astype(np.float32)
    return c, (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)


def test_default_model_train_steps_under_the_override_match_jax(monkeypatch):
    """The default model family at a small width (input 3x8x8, MLP nets
    192->32->6 in fp32, 2 flows of one block 6->16->16->12, a random K=8
    metric, B=3, 3 frames), JAX's on the kernel pair in interpret mode;
    both overrides at 0, so both backwards are the sequential one: 2
    ``make_train_step`` steps."""
    c, m = _metric_arrays()
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
    kw = dict(input_dim=(3, 8, 8), latent_dim=D, n_flows=2, flow_hidden_size=H,
              flow_n_blocks=1, flow_n_hidden=2, flow_log_var_bias_init=0.0,
              loop_mode="closed", encoder_config=net, decoder_config=net)
    jm = JaxRlVAE(metric=JaxMetric.create(c, m, temperature=3.0, regularization=0.01), **kw)
    jm.flow_config.backend = "pallas"
    jv = jm.init(jax.random.PRNGKey(0))
    pm = RlVAE(metric=CentroidMetric.create(c, m, temperature=3.0, regularization=0.01), **kw)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    monkeypatch.setattr(jax_iaf_kernels, "ADJ_SWEEPS_OVERRIDE", 0)
    monkeypatch.setattr(ik, "ADJ_SWEEPS_OVERRIDE", 0)
    launches = ik.iaf_chain_bwd.launches

    x = np.random.default_rng(3).uniform(size=(3, 3, 3, 8, 8)).astype(np.float32)
    jax_opt = jopt.make_optimizer(LR, WD)
    opt_state = jax_opt.init(jv["params"])
    jstep = jax_make_train_step(jm, jax_opt)
    pstep = make_train_step(pm, make_optimizer(pm.parameters(), LR, WD))
    for i in range(2):
        key = jax.random.PRNGKey(100 + i)
        eps = torch.from_numpy(np.asarray(jax.random.normal(jax.random.split(key)[0], (3, D))))
        jv, opt_state, jmet = jstep(jv, opt_state, jnp.asarray(x), key)
        pmet = pstep(torch.from_numpy(x), eps)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(pm)),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jv["params"]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    assert ik.iaf_chain_bwd.launches == launches  # the CPU runs the plain version


@pytest.mark.parametrize("n_sweeps", [-1, -16, 1.5])
def test_check_sweeps_rejects_negatives_and_fractions(n_sweeps):
    with pytest.raises(ValueError, match="n_sweeps"):
        ik._check_sweeps(n_sweeps, D, torch.zeros(B, D))


def test_sequential_mode_needs_z0():
    flows, chain = _chain(0.0)
    w = [x.detach() for x in ik.stack_chain(chain)]
    _, _, ys = ik.iaf_chain_fwd_ref(torch.zeros(B, D), *w, return_ys=True)
    with pytest.raises(ValueError, match="z0"):
        ik.iaf_chain_bwd(ys, torch.zeros(NT, B, D), torch.zeros(NT, B), *w, n_sweeps=0)
    assert ik._check_sweeps(0, D, torch.zeros(B, D)) == 0
    assert ik._check_sweeps(None, D) == D
