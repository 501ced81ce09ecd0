"""The Jacobi fixed-point mode of the IAF chain (``fp_iters``) against the
JAX package on the CPU.

- The plain chain forward (``iaf_chain_fwd_ref(..., fp_iters=K)``) and its
  VJP at K + 1 adjoint sweeps (``IAFChain`` on CPU tensors: dz0 and the six
  weight gradients, through the stacking autograd that applies the masks
  and sums a reused flow's gradients) against JAX's kernel pair
  ``get_fused_iaf_chain(..., interpret=True, fp_iters=K)`` at K = 2, 8 and
  D - 1 = 9 (D=10, H=16, 2 blocks of 3 hidden layers, 3 transitions over 2
  flows, B=5).
- ``iaf_forward_fixedpoint`` and ``fixedpoint_error`` against
  ``rlvae_tpu.flows.iaf``.
- The default model with ``flow_fixedpoint_iters: 8`` (latent 10, so K=8
  is below D - 1 and the iterate is not exact; input 3x8x8, MLP nets
  192->32->10 in fp32, 2 flows of 2 blocks 10->16->16->16->20, a random K=8
  metric, B=3, 4 frames): its forward and 3 ``make_train_step`` steps
  against JAX's model with ``flow_config.backend = "pallas"``, whose chain
  is the kernel pair in interpret mode.  The gradient to hold to is that
  pair's: at K < D - 1 the kernel's VJP is the implicit adjoint at K + 1
  sweeps, not autodiff through the iterations that JAX's CPU path
  (``apply_temporal_flows``'s XLA branch) gives.
- The fast preset with ``flow_fixedpoint_iters > 0``: its sampling-direction
  flows ignore it, in JAX and here.

Tolerances: fp32 on both sides, the same operations in another order: the
chain within 1e-5 of each transition's largest |z| (log-dets 1e-5 of
max(1, |ld|)), gradients within 1e-5 of each tensor's largest entry; the
model's losses rtol 1e-4 (atol 1e-5), step-1 gradients 1e-5 of each
tensor's scale, parameters after 3 steps atol 2e-5 (2% of one Adam step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.flows.iaf import fixedpoint_error as jax_fixedpoint_error
from rlvae_tpu.flows.iaf import iaf_forward_fixedpoint as jax_iaf_forward_fixedpoint
from rlvae_tpu.flows.iaf import iaf_masks
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.models import create_model as jax_create_model
from rlvae_tpu.models.rlvae import RlVAE as JaxRlVAE
from rlvae_tpu.ops.iaf_kernels import get_fused_iaf_chain
from rlvae_tpu.train import optim as jopt
from rlvae_tpu.train.trainer import make_train_step as jax_make_train_step
from rlvae_tpu_torch.convert import from_jax_variables, params_to_numpy
from rlvae_tpu_torch.flows import TemporalFlows, fixedpoint_error, iaf_forward_fixedpoint
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.models import PRESETS, create_model
from rlvae_tpu_torch.models.rlvae import RlVAE
from rlvae_tpu_torch.ops.iaf_kernels import IAFChain, iaf_chain_fwd_ref, stack_chain
from rlvae_tpu_torch.train import make_optimizer, make_train_step

D, H, NB, NH, NT, B = 10, 16, 2, 3, 3, 5
RTOL = 1e-5
LR, WD = 1e-3, 1e-4
LOSS_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty", "grad_norm")


def _jax_block(block):
    return {f"{k}{li}": jnp.asarray(getattr(block, "weights" if k == "w" else "biases")[li]
                                    .detach().numpy())
            for k in "wb" for li in range(block.n_layers)}


def _flows(bias=0.0, n_flows=2, d=D, seed=0):
    g = torch.Generator().manual_seed(seed)
    return TemporalFlows(d, n_flows, H, NB, NH, log_var_bias_init=bias, generator=g)


def _scaled_close(got, want, rtol=RTOL, floor=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), floor)
    assert float(np.abs(got - want).max()) <= rtol * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("k", [2, 8, D - 1])
def test_plain_jacobi_chain_and_vjp_match_the_interpret_kernel(k):
    flows = _flows()
    chain = [flows.flows[min(t, 1)] for t in range(NT)]
    jchain = [[_jax_block(b) for b in iaf.blocks] for iaf in chain]
    rng = np.random.default_rng(k)
    z0 = rng.normal(size=(B, D)).astype(np.float32)
    dz = rng.normal(size=(NT, B, D)).astype(np.float32)
    dld = rng.normal(size=(NT, B)).astype(np.float32)
    f = get_fused_iaf_chain(D, H, NB, NH, NT, interpret=True, fp_iters=k)
    (z_j, ld_j), vjp = jax.vjp(f, jchain, jnp.asarray(z0))
    g_chain, g_z0 = vjp((jnp.asarray(dz), jnp.asarray(dld)))

    zt = torch.from_numpy(z0).requires_grad_(True)
    z, ld = IAFChain.apply(zt, *stack_chain(chain), k)
    ((z * torch.from_numpy(dz)).sum() + (ld * torch.from_numpy(dld)).sum()).backward()
    for t in range(NT):
        _scaled_close(z[t].detach(), z_j[t])
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ld_j), rtol=RTOL,
                               atol=RTOL * max(1.0, float(np.abs(ld_j).max())))
    _scaled_close(zt.grad, g_z0)
    for fi, iaf in enumerate(flows.flows):
        uses = [t for t in range(NT) if min(t, 1) == fi]
        for bi, block in enumerate(iaf.blocks):
            for kind, params in (("w", block.weights), ("b", block.biases)):
                for li, p in enumerate(params):
                    want = sum(np.asarray(g_chain[t][bi][f"{kind}{li}"]) for t in uses)
                    _scaled_close(p.grad, want)
    # the plain forward alone is the same function
    z_r, ld_r = iaf_chain_fwd_ref(torch.from_numpy(z0), *stack_chain(chain), fp_iters=k)
    assert torch.equal(z_r, z.detach()) and torch.equal(ld_r, ld.detach())


@pytest.mark.parametrize("bias", [0.0, -2.0])
def test_iaf_forward_fixedpoint_and_error_match_jax(bias):
    """Per IAF; at the reference init (-2.0) K=3 is far from converged, so
    fixedpoint_error reports a large deviation on both sides."""
    iaf = _flows(bias).flows[0]
    params = [_jax_block(b) for b in iaf.blocks]
    masks = iaf_masks(D, H, NH)
    x = np.random.default_rng(1).normal(size=(B, D)).astype(np.float32)
    for k in (3, D - 1):
        y_j, ld_j = jax_iaf_forward_fixedpoint(params, masks, jnp.asarray(x), n_iters=k)
        y, ld = iaf_forward_fixedpoint(iaf, torch.from_numpy(x), n_iters=k)
        _scaled_close(y.detach(), y_j)
        _scaled_close(ld.detach(), ld_j, floor=1.0)
        got = fixedpoint_error(iaf, torch.from_numpy(x), k)
        want = jax_fixedpoint_error(params, masks, jnp.asarray(x), k)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert got[0] < 1e-5  # K = D - 1 is exact up to rounding


def _metric_arrays(k=8, d=D, seed=0):
    rng = np.random.default_rng(seed)
    c = (0.5 * rng.normal(size=(k, d))).astype(np.float32)
    a = (rng.normal(size=(k, d, d)) / np.sqrt(d)).astype(np.float32)
    return c, (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)


def _default_model_pair(fp_iters=8):
    """The default preset's model family at a small width, JAX's on the
    kernel pair (interpret mode) and the port's carrying its variables."""
    c, m = _metric_arrays()
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
    kw = dict(input_dim=(3, 8, 8), latent_dim=D, n_flows=2, flow_hidden_size=H,
              flow_n_blocks=NB, flow_n_hidden=NH, flow_log_var_bias_init=0.0,
              flow_fixedpoint_iters=fp_iters, loop_mode="closed", encoder_config=net,
              decoder_config=net)
    jm = JaxRlVAE(metric=JaxMetric.create(c, m, temperature=3.0, regularization=0.01), **kw)
    jm.flow_config.backend = "pallas"
    jv = jm.init(jax.random.PRNGKey(0))
    pm = RlVAE(metric=CentroidMetric.create(c, m, temperature=3.0, regularization=0.01), **kw)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    return jm, jv, pm


def test_default_model_forward_and_three_train_steps_match_the_kernel_pair():
    jm, jv, pm = _default_model_pair()
    assert pm.flows.fixedpoint_iters == 8 and jm.flow_config._use_fused()
    x = np.random.default_rng(2).uniform(size=(3, 4, 3, 8, 8)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    jax_opt = jopt.make_optimizer(LR, WD)
    opt_state = jax_opt.init(jv["params"])
    jstep = jax_make_train_step(jm, jax_opt)
    pstep = make_train_step(pm, make_optimizer(pm.parameters(), LR, WD))
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        eps = torch.from_numpy(np.asarray(jax.random.normal(jax.random.split(key)[0], (3, D))))
        jv, opt_state, jmet = jstep(jv, opt_state, xj, key)
        pmet = pstep(xt, eps)  # the forward's loss terms, then the Adam update
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(pm)),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jv["params"]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


def test_fast_preset_with_fixedpoint_iters_runs_and_equals_jax(tmp_path):
    """``riemannian_flow_vae_fast`` with ``flow_fixedpoint_iters: 8``: the
    sampling-direction chain ignores it on both sides; the eval forward
    equals JAX's at a small width (latent 4, a K=8 metric written as an
    .npz that both factories load, the decoder's output in fp32 rather than
    the preset's bf16)."""
    c, m = _metric_arrays(d=4)
    path = tmp_path / "metric.npz"
    np.savez(path, centroids=c, M_matrices=m, temperature=np.float32(1.0),
             regularization=np.float32(0.01))
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
    preset = PRESETS["riemannian_flow_vae_fast"]
    cfg = {**preset, "input_dim": [3, 8, 8], "latent_dim": 4, "n_flows": 2,
           "flow_hidden_size": 16, "flow_fixedpoint_iters": 8, "encoder": net,
           "decoder": {**preset["decoder"], **net, "out_dtype": "float32"},
           "pretrained": {"metric_path": str(path)}}
    jm = jax_create_model(cfg)
    jv = jm.init(jax.random.PRNGKey(0))
    pm = create_model(cfg)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    assert pm.flows.direction == "sampling" and pm.flows.fixedpoint_iters == 8
    x = np.random.default_rng(3).uniform(size=(3, 8, 3, 8, 8)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jout = jax.jit(lambda v: {k: v_ for k, v_ in jm.forward(v, jnp.asarray(x), key).items()
                              if k in ("z", "loss", "recon_loss", "kld_loss", "flow_loss")})(jv)
    eps = torch.from_numpy(np.asarray(jax.random.normal(jax.random.split(key)[0], (3, 4))))
    with torch.no_grad():
        pout = pm(torch.from_numpy(x), eps)
    _scaled_close(pout["z"], jout["z"])
    for k in ("loss", "recon_loss", "kld_loss", "flow_loss"):
        np.testing.assert_allclose(float(pout[k]), float(jout[k]), rtol=1e-4, atol=1e-5)
