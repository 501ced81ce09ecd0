"""The fast and stable presets of the port against the JAX package on the CPU.

- ``iaf_inverse`` and the sampling-direction temporal chain against JAX's
  ``iaf_inverse`` and ``apply_temporal_flows``, one transition at a time
  from the port's own input to it, at the near-identity (0.0) and the
  reference (-2.0) log-sigma bias init.
- ``PRESETS["riemannian_flow_vae_stable"]`` and ``["riemannian_flow_vae_fast"]``
  against the composed ``conf/model/*.yaml``.
- Whole models at a small width (input 3x8x8, latent 4, nets 192->32->4,
  2 flows of 2 MADE blocks 4->32->32->32->8, a random K=8 metric at the
  presets' T=3.0, B=3, T=4), built from the presets on both sides; one set
  of JAX variables (``jm.init(PRNGKey(0))``) is carried into every port
  model by ``convert.from_jax_variables``, and JAX's posterior noise
  ``normal(split(key)[0], (B, D))`` is handed to the port.  JAX's compared
  forwards and gradients are one jitted program, computed once per module;
  the JAX fast model's training forward runs the ``decode_mse`` Pallas
  kernel in interpret mode.

Tolerances and why (bf16 nets, as tests/test_torch_train.py states them):
- flows: 1e-5 of max(1, |z|) (fp32, the same operations); log-dets 1e-5 of
  max(1, |ld|).
- training forward and step 1 against JAX: loss terms rtol 1e-3, gradients
  within 2e-2 of each tensor's largest entry (the frameworks round the bf16
  products at other places, 2^-8 relative per rounding); the 3 steps'
  losses rtol 2e-2.
- the fused loss against the port's own plain loss: 5e-3 relative, and
  gradients within 5e-2 of scale, as tests/test_model.py holds JAX's (the
  kernel's bf16 operands against the bf16 decoder's output rounding).
- serving against JAX's eval forward: the bf16 reconstruction within 1e-2
  (a few bf16 steps of values in (0, 1)), its mean difference within 1e-3.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.config import compose
from rlvae_tpu.flows.iaf import iaf_inverse as jax_iaf_inverse
from rlvae_tpu.flows.iaf import iaf_masks
from rlvae_tpu.flows.temporal import TemporalFlowConfig
from rlvae_tpu.flows.temporal import apply_temporal_flows as jax_temporal
from rlvae_tpu.models import create_model as jax_create_model
from rlvae_tpu.train import optim as jopt
from rlvae_tpu.train.trainer import make_train_step as jax_make_train_step
from rlvae_tpu_torch import BatchingEngine, ModelManager, ServeConfig
from rlvae_tpu_torch.convert import from_jax_variables, params_to_numpy
from rlvae_tpu_torch.flows import TemporalFlows, apply_temporal_flows, iaf_inverse
from rlvae_tpu_torch.models import PRESETS, create_model
from rlvae_tpu_torch.nets.mlp import MLPDecoder
from rlvae_tpu_torch.ops import recon_kernels
from rlvae_tpu_torch.ops.recon_kernels import decode_mse, decode_mse_bwd_dh, decode_mse_bwd_dw
from rlvae_tpu_torch.train import make_optimizer, make_train_step

CONF = Path(__file__).resolve().parents[1] / "conf"
FAST, STABLE = "riemannian_flow_vae_fast", "riemannian_flow_vae_stable"
B, T, D = 3, 4, 4
LOSSES = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty")
LR, WD = 1e-3, 1e-4


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _close_scaled(got, want, rtol, what=""):
    """Every leaf within rtol of that leaf's largest |entry|."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i)
        scale = max(float(np.abs(b).max()), 1e-12)
        err = float(np.abs(a - b).max())
        assert err <= rtol * scale, f"{what} leaf {i}: {err} > {rtol} * {scale}"


# ---------------------------------------------------------------------------
# the sampling direction
# ---------------------------------------------------------------------------


def _jax_flow_params(iaf):
    """The JAX params (w0.., b0.. per MADE block) of one port IAF."""
    return [{**{f"w{li}": jnp.asarray(blk.weights[li].detach().numpy())
                for li in range(blk.n_layers)},
             **{f"b{li}": jnp.asarray(blk.biases[li].detach().numpy())
                for li in range(blk.n_layers)}}
            for blk in iaf.blocks]


def _assert_rel(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_less(np.abs(got - want), rtol * np.maximum(1.0, np.abs(want)),
                                 err_msg=what)


@pytest.mark.parametrize("bias", [0.0, -2.0])
def test_sampling_chain_matches_jax(bias):
    """Each transition of the port's sampling chain (3 flows, the last
    reused at 5 transitions) against JAX's iaf_inverse and against JAX's
    apply_temporal_flows over that one transition, from the port's input."""
    g = torch.Generator().manual_seed(1)
    flows = TemporalFlows(D, n_flows=3, hidden_size=64, n_blocks=2, n_hidden=3,
                          direction="sampling", log_var_bias_init=bias, generator=g)
    z0 = torch.tensor(np.random.default_rng(2).normal(size=(5, D)), dtype=torch.float32)
    with torch.no_grad():
        z_seq, lds = apply_temporal_flows(flows, z0, 8)
    assert z_seq.shape == (5, 8, D) and lds.shape == (5, 7)
    assert torch.equal(z_seq[:, 0], z0)
    masks = iaf_masks(D, 64, 3)
    cfg = TemporalFlowConfig(D, n_flows=1, hidden_size=64, n_blocks=2, n_hidden=3,
                             direction="sampling", log_var_bias_init=bias)
    for t in range(7):
        iaf = flows.flows[min(t, 2)]
        params = _jax_flow_params(iaf)
        z_in = jnp.asarray(z_seq[:, t].numpy())
        y_j, ld_j = jax_iaf_inverse(params, masks, z_in)
        _assert_rel(z_seq[:, t + 1].numpy(), y_j, 1e-5, f"transition {t}: z")
        _assert_rel(lds[:, t].numpy(), ld_j, 1e-5, f"transition {t}: logdet")
        zc_j, ldc_j = jax_temporal(cfg, [params], z_in, 2)
        _assert_rel(z_seq[:, t + 1].numpy(), zc_j[:, 1], 1e-5, f"chain step {t}: z")
        _assert_rel(lds[:, t].numpy(), ldc_j[:, 0], 1e-5, f"chain step {t}: logdet")
        with torch.no_grad():
            y_t, ld_t = iaf_inverse(iaf, z_seq[:, t])
        assert torch.equal(y_t, z_seq[:, t + 1]) and torch.equal(ld_t, lds[:, t])


# ---------------------------------------------------------------------------
# the presets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [STABLE, FAST])
def test_preset_matches_composed_config(name):
    composed = compose(CONF, overrides=[f"model={name}"]).model.to_dict()
    preset = PRESETS[name]
    for key, value in composed.items():
        if key in ("_target_", "epsilon", "flow_n_hidden"):
            continue  # factory-only keys; flow_n_hidden is forced to 3 on both sides
        assert preset[key] == value, key
    jm, pm = jax_create_model(composed), create_model(preset)
    for attr in ("posterior_type", "sampling_method", "loop_mode", "flow_loss_mode",
                 "riemannian_beta", "fused_decode_mse", "remat_decode"):
        assert getattr(pm, attr) == getattr(jm, attr), attr
    assert pm.flows.direction == jm.flow_config.direction == "sampling"
    assert torch.all(pm.flows.flows[0].blocks[0].biases[-1][pm.latent_dim:] == 0.0)
    assert pm.metric.n_centroids == 50 and pm.metric.temperature == 3.0
    want_out = "bfloat16" if name == FAST else "float32"
    assert pm.decoder.out_dtype == getattr(torch, want_out)
    assert jnp.dtype(jm.decoder.out_dtype) == jnp.dtype(want_out)


# ---------------------------------------------------------------------------
# whole models at a small width
# ---------------------------------------------------------------------------

KEY, SERVE_KEY = 5, 11  # the PRNG keys of the compared training and serving forwards
CONFIGS = [(name, loop) for name in (STABLE, FAST) for loop in ("open", "closed")]


def _small(name, metric_path, loop="open", **overrides):
    """The preset at the small width, with the small metric."""
    p = PRESETS[name]
    net = {"architecture": "mlp", "hidden_dims": [32]}
    return {**p, "input_dim": [3, 8, 8], "latent_dim": D, "n_flows": 2, "flow_hidden_size": 32,
            "encoder": net, "decoder": {**p["decoder"], **net},
            "loop": {"mode": loop, "penalty": 5.0},
            "pretrained": {"metric_path": metric_path}, **overrides}


def _batch(seed=1):
    return np.random.default_rng(seed).uniform(size=(B, T, 3, 8, 8)).astype(np.float32)


def _eps(key):
    return torch.tensor(np.asarray(jax.random.normal(jax.random.split(key)[0], (B, D))))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX side, computed once: a K=8 metric in D=4 written as an .npz
    (both factories load it, with the presets' temperature override 3.0),
    one set of JAX variables for every model (same architecture), and, in
    one jitted program, every compared training forward with its gradients
    and the fast preset's eval forward."""
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(8, D, D)) / np.sqrt(D)).astype(np.float32)
    path = tmp_path_factory.mktemp("metric") / "metric.npz"
    np.savez(path, centroids=(0.5 * rng.normal(size=(8, D))).astype(np.float32),
             M_matrices=(a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(D, dtype=np.float32)),
             temperature=np.float32(1.0), regularization=np.float32(0.01))
    jms = {f"{n}-{loop}": jax_create_model(_small(n, str(path), loop)) for n, loop in CONFIGS}
    jv = jax.jit(jms[f"{STABLE}-open"].init)(jax.random.PRNGKey(0))
    x, xs = jnp.asarray(_batch()), jnp.asarray(_batch(seed=3))

    @jax.jit
    def run(params):
        out = {}
        for k, jm in jms.items():
            def loss(p, jm=jm):
                o = jm.forward({**jv, "params": p}, x, jax.random.PRNGKey(KEY), train=True)
                return o.loss, {t: o[t] for t in LOSSES}

            (_, terms), grads = jax.value_and_grad(loss, has_aux=True)(params)
            out[k] = (terms, grads)
        ev = jms[f"{FAST}-open"].forward(jv, xs, jax.random.PRNGKey(SERVE_KEY), train=False)
        out["eval"] = {t: ev[t] for t in ("recon_x",) + LOSSES[:-1]}
        return out

    return {"metric_path": str(path), "jms": jms,
            "jv": jax.tree_util.tree_map(np.asarray, jv),
            "out": jax.tree_util.tree_map(np.asarray, run(jv["params"]))}


def _port(ref, name, loop="open", **overrides):
    """The port's model of that preset, on JAX's variables."""
    pm = create_model(_small(name, ref["metric_path"], loop, **overrides))
    pm.load_state_dict(from_jax_variables(ref["jv"]))
    return pm


def _port_grads(pm):
    g = copy.deepcopy(pm)
    for p, q in zip(g.parameters(), pm.parameters()):
        p.data = (q.grad if q.grad is not None else torch.zeros_like(q)).detach().clone()
    return params_to_numpy(g)


def _port_train_forward(pm, x, eps):
    pm.zero_grad(set_to_none=True)
    out = pm(torch.from_numpy(x), eps, train=True)
    out.loss.backward()
    return out, _port_grads(pm)


@pytest.mark.parametrize("loop", ["open", "closed"])
@pytest.mark.parametrize("name", [STABLE, FAST])
def test_train_forward_and_gradients_match_jax(ref, name, loop):
    pm = _port(ref, name, loop)
    jo, jgrads = ref["out"][f"{name}-{loop}"]
    x, eps = _batch(), _eps(jax.random.PRNGKey(KEY))
    out, pgrads = _port_train_forward(pm, x, eps)
    for k in LOSSES:
        np.testing.assert_allclose(float(out[k].detach()), float(jo[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    _close_scaled(pgrads, jgrads, 2e-2, "gradients")
    if name == FAST:
        assert out.recon_x is None
        pm.fused_decode_mse = False  # the port's own plain loss, same weights and noise
        plain, plain_grads = _port_train_forward(pm, x, eps)
        assert plain.recon_x is not None
        fused_loss, plain_loss = float(out.loss.detach()), float(plain.loss.detach())
        assert abs(fused_loss - plain_loss) < 5e-3 * abs(plain_loss)
        _close_scaled(pgrads, plain_grads, 5e-2, "fused vs plain gradients")


def test_fused_train_forward_launches_the_wrappers_and_no_full_decode(ref, monkeypatch):
    """The fused train forward calls the decoder's hidden stack and
    decode_mse, never MLPDecoder.forward; the backward calls both backward
    wrappers once.  The eval forward and a train forward with the analysis
    metrics decode the reconstruction."""
    pm = _port(ref, FAST)
    calls = {"decode": 0}
    own_forward = MLPDecoder.forward

    def counting_forward(self, z):
        calls["decode"] += 1
        return own_forward(self, z)

    monkeypatch.setattr(MLPDecoder, "forward", counting_forward)
    x, eps = torch.from_numpy(_batch()), _eps(jax.random.PRNGKey(KEY))
    seen = []
    for name in ("decode_mse", "decode_mse_bwd_dh", "decode_mse_bwd_dw"):
        fn = getattr(recon_kernels, name)
        monkeypatch.setattr(recon_kernels, name,
                            lambda *a, _fn=fn, _n=name: seen.append(_n) or _fn(*a))
    out = pm(x, eps, train=True)
    out.loss.backward()
    assert out.recon_x is None and calls["decode"] == 0
    assert seen == ["decode_mse", "decode_mse_bwd_dh", "decode_mse_bwd_dw"]
    with torch.no_grad():
        assert pm(x, eps, train=False).recon_x.shape == x.shape and calls["decode"] == 1
        with_metrics = pm(x, eps, train=True, compute_metrics=True)
    assert calls["decode"] == 2 and with_metrics.recon_x is not None
    assert len(seen) == 4  # the fused loss all the same


def test_remat_decode_gives_the_plain_numbers(ref):
    """remat_decode checkpoints the decode and the reconstruction loss: the
    same loss and gradients as the plain path, and no kept reconstruction."""
    plain = _port(ref, STABLE, "closed")
    remat = _port(ref, STABLE, "closed", remat_decode=True)
    assert remat.remat_decode and not remat.fused_decode_mse
    x, eps = _batch(), _eps(jax.random.PRNGKey(KEY))
    out_p, g_p = _port_train_forward(plain, x, eps)
    out_r, g_r = _port_train_forward(remat, x, eps)
    assert out_r.recon_x is None
    for k in LOSSES:
        assert float(out_r[k].detach()) == float(out_p[k].detach()), k
    for a, b in zip(_leaves(g_r), _leaves(g_p)):
        np.testing.assert_array_equal(a, b)


def test_three_fast_train_steps_match_jax(ref):
    """JAX's make_train_step against the port's, 3 steps of the fast preset
    from the same variables; step 1 is the compared training forward."""
    jm, pm = ref["jms"][f"{FAST}-open"], _port(ref, FAST)
    jv = jax.tree_util.tree_map(jnp.asarray, ref["jv"])
    jax_opt = jopt.make_optimizer(LR, WD)
    opt_state = jax_opt.init(jv["params"])
    jstep = jax_make_train_step(jm, jax_opt)
    pstep = make_train_step(pm, make_optimizer(pm.parameters(), LR, WD))
    x = _batch()
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    launches = (decode_mse.launches, decode_mse_bwd_dh.launches, decode_mse_bwd_dw.launches)
    for i in range(3):
        key = jax.random.PRNGKey(KEY + i)
        jv, opt_state, jmet = jstep(jv, opt_state, xj, key)
        pmet = pstep(xt, _eps(key))
        if i == 0:
            _close_scaled(_port_grads(pm), ref["out"][f"{FAST}-open"][1], 2e-2,
                          "step-1 gradients")
        for k in LOSSES + ("grad_norm",):
            rtol = 1e-3 if i == 0 else 2e-2
            np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=rtol, atol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
    # CPU tensors: the plain versions ran, no kernel was launched
    assert (decode_mse.launches, decode_mse_bwd_dh.launches,
            decode_mse_bwd_dw.launches) == launches


def test_fast_eval_forward_equals_the_unfused_model(ref):
    """train=False never takes the fused loss (JAX: tests/test_model.py:448-451):
    the fast preset's eval forward equals, bit for bit, the same model with
    fused_decode_mse off.  (The stable preset also differs by the decoder's
    fp32 output, so its reconstruction is not the fast preset's.)"""
    fast, unfused = _port(ref, FAST), _port(ref, FAST, fused_decode_mse=False)
    x, eps = torch.from_numpy(_batch()), _eps(jax.random.PRNGKey(9))
    with torch.no_grad():
        a, b = fast(x, eps, train=False), unfused(x, eps, train=False)
    for k in ("recon_x", "z", "mu", "log_var") + LOSSES:
        assert torch.equal(a[k], b[k]), k


def test_serving_the_fast_preset_matches_jax(ref):
    """ModelManager.from_config of the (small) fast preset on the CPU: its
    forward on JAX's noise against JAX's forward(train=False), reconstruct
    as forward's reconstruction, and one engine bucket as reconstruct."""
    manager = ModelManager.from_config(_small(FAST, ref["metric_path"]), seed=0, device="cpu")
    manager.model.load_state_dict(from_jax_variables(ref["jv"]))
    jo = ref["out"]["eval"]
    x = _batch(seed=3)
    out = manager.forward(x, eps=_eps(jax.random.PRNGKey(SERVE_KEY)))
    got, want = out.recon_x.float().numpy(), np.asarray(jo["recon_x"], np.float32)
    assert out.recon_x.dtype == torch.bfloat16 and got.shape == x.shape
    assert float(np.abs(got - want).max()) <= 1e-2
    assert float(np.abs(got - want).mean()) <= 1e-3
    for k in ("loss", "recon_loss", "kld_loss", "flow_loss"):
        np.testing.assert_allclose(float(out[k]), float(jo[k]), rtol=1e-3, err_msg=k)
    rec = manager.reconstruct(x, seed=4)
    np.testing.assert_array_equal(rec, manager.forward(x, seed=4).recon_x.float().numpy())
    engine = BatchingEngine.from_manager(manager, ServeConfig(buckets=(B,), max_wait_ms=2000))
    try:
        futs = [engine.submit("reconstruct", x[i]) for i in range(B)]
        rows = np.stack([f.result(timeout=30) for f in futs])
    finally:
        engine.stop()
    np.testing.assert_array_equal(rows, manager.reconstruct(x))


def test_fast_preset_serves_at_full_width_on_the_cpu():
    manager = ModelManager.from_config(PRESETS[FAST], seed=0, device="cpu")
    assert manager.model.fused_decode_mse and manager.model.flows.direction == "sampling"
    x = np.random.default_rng(4).uniform(size=(1, 8, 3, 64, 64)).astype(np.float32)
    rec = manager.reconstruct(x)
    assert rec.shape == x.shape and np.all(np.isfinite(rec))
    assert rec.min() >= 0.0 and rec.max() <= 1.0
