"""The port's training path against the JAX package on the CPU.

- ``cholesky_small``, the triangular solve and ``logdet_from_chol`` under
  autograd against ``jax.grad`` of rlvae_tpu.ops.linalg; the chol-bundle
  Function's gradient against ``jax.grad`` through ``chol_g_inv``.
- ``make_train_step`` against the JAX ``make_train_step``
  (``rlvae_tpu/train/trainer.py:114-132``) on a small model (input 3x16x16,
  latent 8, flows of 2 MADE blocks 8->32->32->32->16, MLP nets 768->32->8,
  a random K=8 metric), with the JAX model's variables carried across by
  ``convert.from_jax_variables`` and eps = normal(split(key_i)[0], (B, D))
  handed to the port.  One config reuses its last flow (3 transitions, 2
  flows, closed loop); one leaves a flow unused (2 transitions, 3 flows,
  open loop), which coupled weight decay must still move.
- Adam, the plateau scheduler and early stopping against rlvae_tpu.train.optim;
  the training and data presets against the composed config; the synthetic
  data and the data module against rlvae_tpu.data; the trainer end to end.

Tolerances and why:
- linalg and chol-bundle gradients: rtol 1e-4, atol 1e-5 (fp32, another
  summation order through a 16-step factorization whose conditioning
  amplifies rounding, as the forward tests of test_torch_metric.py state).
- fp32 train steps at the near-identity flow init (log-sigma bias 0.0):
  step-1 gradients within 1e-5 of each tensor's largest entry; every step's
  losses and grad_norm rtol 1e-4 (atol 1e-5); parameters after 3 steps
  atol 2e-5, 2% of one Adam step of lr 1e-3: a sign flip of an update or a
  missing decay step would show as ~1e-3.
- fp32 at the reference init (-2.0), where each transition scales the
  latent ~20x and the cotangents with it: step-1 gradients within 5e-4 of
  each tensor's scale, step-1 losses rtol 1e-4.  Later steps are not
  compared there: Adam's first updates are +-lr for entries whose gradient
  is below the amplified rounding, so the two trajectories part by ~lr.
- bf16 nets (the default dtype): the frameworks round bf16 products at other
  places (2^-8 relative per rounding): step-1 losses rtol 1e-3, step-1
  gradients within 2e-2 of each tensor's scale, the 3 steps' losses rtol 2e-2.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.config import compose
from rlvae_tpu.data.cyclic import CyclicDataModule as JaxDataModule
from rlvae_tpu.data.cyclic import batch_iterator as jax_batch_iterator
from rlvae_tpu.data.synth import generate_cyclic_sequences as jax_generate
from rlvae_tpu.geometry import metric as jgm
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.models.rlvae import RlVAE as JaxRlVAE
from rlvae_tpu.ops import linalg as jlin
from rlvae_tpu.train import optim as jopt
from rlvae_tpu.train.trainer import make_train_step as jax_make_train_step
from rlvae_tpu_torch.convert import from_jax_variables, params_to_numpy
from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule, batch_iterator
from rlvae_tpu_torch.data import generate_cyclic_sequences
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.geometry import metric as tgm
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.models import PRESETS, create_model
from rlvae_tpu_torch.models.rlvae import RlVAE
from rlvae_tpu_torch.ops import linalg as tlin
from rlvae_tpu_torch.flows import apply_temporal_flows
from rlvae_tpu_torch.ops.iaf_kernels import (
    iaf_chain_bwd,
    iaf_chain_fwd,
    iaf_chain_fwd_ref,
    stack_chain,
)
from rlvae_tpu_torch.ops.metric_kernels import CholBundle, chol_bundle
from rlvae_tpu_torch.train import (
    TRAINING_PRESETS,
    EarlyStopping,
    PlateauScheduler,
    Trainer,
    get_lr,
    make_optimizer,
    make_train_step,
    set_lr,
)
from rlvae_tpu_torch.train.__main__ import main as train_main

CONF = Path(__file__).resolve().parents[1] / "conf"
DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
LR, WD, B, LATENT = 1e-3, 1e-4, 4, 8
LOSS_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty", "grad_norm")


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


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
# linalg and the chol-bundle under autograd
# ---------------------------------------------------------------------------


def _spd(rng, b, d=16):
    a = rng.normal(size=(b, d, d)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / d + 0.5 * np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
def test_cholesky_small_gradient_matches_jax(jitter):
    rng = np.random.default_rng(0)
    a = _spd(rng, 6)
    w = rng.normal(size=a.shape).astype(np.float32)
    want = jax.grad(lambda m: jnp.sum(jlin.cholesky_small(m, jitter=jitter) * w))(jnp.asarray(a))
    at = torch.from_numpy(a).requires_grad_(True)
    (tlin.cholesky_small(at, jitter=jitter) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_triangular_solve_and_logdet_gradients_match_jax():
    rng = np.random.default_rng(1)
    l = np.array(jlin.cholesky_small(jnp.asarray(_spd(rng, 5))))
    b = rng.normal(size=(5, 16)).astype(np.float32)
    w = rng.normal(size=(5, 16)).astype(np.float32)

    def jax_loss(l, b):
        return jnp.sum(jlin.tri_solve_lower(l, b) * w) + jnp.sum(jlin.logdet_from_chol(l))

    want_l, want_b = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(l), jnp.asarray(b))
    lt, bt = (torch.from_numpy(v).requires_grad_(True) for v in (l, b))
    ((tlin.tri_solve_lower(lt, bt) * torch.from_numpy(w)).sum()
     + tlin.logdet_from_chol(lt).sum()).backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_l), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want_b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("jitter", [1e-6, 0.0])
@pytest.mark.parametrize("name,t_override", [("metric_T0.7_scaled.npz", 3.0), ("metric.npz", None)])
def test_chol_bundle_gradient_matches_jax(name, t_override, jitter):
    """CholBundle (forward: the bundle, backward: autograd through its plain
    version) against jax.grad through chol_g_inv, in z only."""
    from rlvae_tpu.geometry import load_metric as jax_load_metric

    jm = jax_load_metric(DATA / name, temperature_override=t_override)
    tm = load_metric(DATA / name, temperature_override=t_override)
    rng = np.random.default_rng(2)
    c = np.asarray(jm.centroids)
    z = (c[rng.integers(0, c.shape[0], size=7)] + 0.05 * rng.normal(size=(7, 16))).astype(np.float32)
    w = rng.normal(size=(7, 16, 16)).astype(np.float32)
    want = jax.grad(lambda zz: jnp.sum(jgm.chol_g_inv(jm, zz, jitter=jitter) * w))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    (tgm.chol_g_inv(tm, zt, jitter=jitter) * torch.from_numpy(w)).sum().backward()
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5 * scale)
    assert tm.centroids.grad is None and tm.matrices.grad is None


def test_chol_bundle_function_forward_is_the_bundle():
    """The Function's output is the bundle's factor, bit for bit."""
    tm = load_metric(DATA / "metric_T0.7_scaled.npz", temperature_override=3.0)
    z = (tm.centroids[:5] + 0.1).clone().requires_grad_(True)
    args = (tm.centroids, tm.matrices, 1.0 / 9.0, tm.regularization)
    l = CholBundle.apply(z, *args)
    assert l.requires_grad and torch.equal(l, chol_bundle(z.detach(), *args)[0])


# ---------------------------------------------------------------------------
# one train step and three against the JAX make_train_step
# ---------------------------------------------------------------------------


def _metric_arrays(k=8, d=LATENT, seed=0):
    rng = np.random.default_rng(seed)
    c = (0.5 * rng.normal(size=(k, d))).astype(np.float32)
    a = (rng.normal(size=(k, d, d)) / np.sqrt(d)).astype(np.float32)
    m = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)
    return c, m


def _pair(n_flows, loop_mode, bias, dtype):
    c, m = _metric_arrays()
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": dtype}
    kw = dict(input_dim=(3, 16, 16), latent_dim=LATENT, n_flows=n_flows, flow_hidden_size=32,
              flow_n_blocks=2, flow_n_hidden=3, beta=1.0, riemannian_beta=8.0,
              posterior_type="riemannian_metric", sampling_method="geodesic",
              use_riemannian=True, loop_mode=loop_mode, loop_penalty=5.0,
              flow_log_var_bias_init=bias, encoder_config=net, decoder_config=net)
    jm = JaxRlVAE(metric=JaxMetric.create(c, m, temperature=1.0, regularization=0.01), **kw)
    pm = RlVAE(metric=CentroidMetric.create(c, m, temperature=1.0, regularization=0.01), **kw)
    jv = jm.init(jax.random.PRNGKey(0))
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    return jm, jv, pm


def _grads_to_numpy(model):
    """The port's .grad tensors keyed as the JAX params tree."""
    g = copy.deepcopy(model)
    for p, q in zip(g.parameters(), model.parameters()):
        p.data = q.grad.detach().clone()
    return params_to_numpy(g)


def _run_steps(n_flows, n_obs, loop_mode, bias, dtype, n_steps):
    """(jax metrics, port metrics, jax step-1 grads, port step-1 grads,
    jax params, port params, initial params) after n_steps steps."""
    jm, jv, pm = _pair(n_flows, loop_mode, bias, dtype)
    init = params_to_numpy(pm)
    x = np.random.default_rng(1).uniform(size=(B, n_obs, 3, 16, 16)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    jax_opt = jopt.make_optimizer(LR, WD)
    opt_state = jax_opt.init(jv["params"])
    jstep = jax_make_train_step(jm, jax_opt)
    pstep = make_train_step(pm, make_optimizer(pm.parameters(), LR, WD))
    jmets, pmets = [], []
    for i in range(n_steps):
        key = jax.random.PRNGKey(100 + i)
        eps = np.asarray(jax.random.normal(jax.random.split(key)[0], (B, LATENT)))
        if i == 0:
            jgrads = jax.tree_util.tree_map(np.asarray, jax.grad(
                lambda p: jm.forward({**jv, "params": p}, xj, key, train=True).loss
            )(jv["params"]))
        jv, opt_state, jmet = jstep(jv, opt_state, xj, key)
        pmet = pstep(xt, torch.from_numpy(eps))
        jmets.append({k: float(v) for k, v in jmet.items()})
        pmets.append({k: float(v) for k, v in pmet.items()})
        if i == 0:
            pgrads = _grads_to_numpy(pm)
    jparams = jax.tree_util.tree_map(np.asarray, jv["params"])
    return jmets, pmets, jgrads, pgrads, jparams, params_to_numpy(pm), init


# (n_flows, n_obs, loop mode): the last flow reused at 2 of 3 transitions;
# or 2 transitions over 3 flows, so flow 2 gets no gradient
CONFIGS = {"reused-flow": (2, 4, "closed"), "unused-flow": (3, 3, "open")}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_three_fp32_train_steps_match_jax(config):
    jmets, pmets, jgrads, pgrads, jparams, pparams, init = _run_steps(
        *CONFIGS[config], bias=0.0, dtype="float32", n_steps=3)
    _close_scaled(pgrads, jgrads, 1e-5, "step-1 gradients")
    for i, (jm_, pm_) in enumerate(zip(jmets, pmets)):
        assert set(pm_) == set(LOSS_KEYS) == set(jm_)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(pm_[k], jm_[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
    for a, b in zip(_leaves(pparams), _leaves(jparams)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    if config == "unused-flow":
        for leaf_p, leaf_0, leaf_g in zip(_leaves(pparams["flows"][2]), _leaves(init["flows"][2]),
                                          _leaves(pgrads["flows"][2])):
            assert np.all(leaf_g == 0)
            # coupled decay moves it all the same (as on the JAX side, compared
            # above): Adam's steps are about lr * sign(wd * p)
            moved = np.abs(leaf_p - leaf_0)
            assert np.all((moved > 0) | (leaf_0 == 0)) and moved.max() > 2 * LR


def test_train_step_reference_flow_init_matches_jax():
    jmets, pmets, jgrads, pgrads, *_ = _run_steps(*CONFIGS["reused-flow"], bias=-2.0,
                                                 dtype="float32", n_steps=1)
    _close_scaled(pgrads, jgrads, 5e-4, "step-1 gradients")
    for k in LOSS_KEYS:
        np.testing.assert_allclose(pmets[0][k], jmets[0][k], rtol=1e-4, err_msg=k)


def test_train_steps_bf16_nets_match_jax():
    jmets, pmets, jgrads, pgrads, *_ = _run_steps(*CONFIGS["unused-flow"], bias=0.0,
                                                 dtype="bfloat16", n_steps=3)
    _close_scaled(pgrads, jgrads, 2e-2, "step-1 gradients")
    for k in LOSS_KEYS:
        np.testing.assert_allclose(pmets[0][k], jmets[0][k], rtol=1e-3, atol=1e-5, err_msg=k)
        for i in range(3):
            np.testing.assert_allclose(pmets[i][k], jmets[i][k], rtol=2e-2, atol=1e-5,
                                       err_msg=f"step {i + 1} {k}")


# ---------------------------------------------------------------------------
# optimizer, scheduler, early stopping
# ---------------------------------------------------------------------------


def test_adam_with_coupled_decay_matches_optax():
    """Five updates of torch.optim.Adam(weight_decay) against the JAX chain,
    with a learning-rate change after step 3."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=7).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(5)]
    jax_opt = jopt.make_optimizer(LR, WD)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jax_opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = make_optimizer(tp.values(), LR, WD)
    for i, g in enumerate(grads):
        if i == 3:
            state = jopt.set_lr(state, 0.5 * LR)
            set_lr(topt, 0.5 * LR)
        updates, state = jax_opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    assert get_lr(topt) == pytest.approx(jopt.get_lr(state))
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_plateau_scheduler_and_early_stopping_match_jax():
    values = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 3.0, 3.5, 3.5, 3.5, 3.5, 2.0]
    cfg = {"factor": 0.5, "patience": 2, "threshold": 1e-3, "min_lr": "1e-7"}
    j_s, t_s = jopt.PlateauScheduler.from_config(cfg), PlateauScheduler.from_config(cfg)
    j_e = jopt.EarlyStopping.from_config({"patience": 3, "min_delta": 0.01})
    t_e = EarlyStopping.from_config({"patience": 3, "min_delta": 0.01})
    j_lr = t_lr = 1e-3
    for v in values:
        j_lr, t_lr = j_s.step(v, j_lr), t_s.step(v, t_lr)
        assert t_lr == j_lr
        assert t_e.update(v) == j_e.update(v)
    assert t_lr < 1e-3


# ---------------------------------------------------------------------------
# presets, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["default", "quick"])
def test_training_preset_matches_composed_config(name):
    composed = compose(CONF, overrides=[f"training={name}"]).training.to_dict()
    assert TRAINING_PRESETS[name] == composed


def test_data_preset_matches_composed_config():
    assert CYCLIC_SPRITES == compose(CONF).data.to_dict()


def test_synthetic_data_and_batches_match_jax():
    got = generate_cyclic_sequences(5, n_obs=4, image_size=(16, 16), seed=3)
    want = jax_generate(5, n_obs=4, image_size=(16, 16), seed=3)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got[:, 0], got[:, -1])
    for shuffle, drop in ((True, True), (False, False)):
        a = list(batch_iterator(got, 2, shuffle=shuffle, seed=7, drop_remainder=drop))
        b = list(jax_batch_iterator(want, 2, shuffle=shuffle, seed=7, drop_remainder=drop))
        assert len(a) == len(b)
        assert all(np.array_equal(u, v) for u, v in zip(a, b))


def test_data_module_matches_jax(tmp_path):
    data_cfg = {**CYCLIC_SPRITES, "train_path": str(tmp_path / "missing_train.npz"),
                "test_path": str(tmp_path / "missing_test.npz"), "image_size": [8, 8],
                "synthetic_n_train": 12, "synthetic_n_test": 6}
    tc = {"data": {"batch_size": 4}, "n_train_samples": 10, "n_val_samples": 5}
    port, ref = CyclicDataModule(data_cfg, seed=5), JaxDataModule(data_cfg, seed=5,
                                                                    process_index=0, process_count=1)
    port.setup(tc)
    ref.setup(tc)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(getattr(port, split).data, getattr(ref, split).data)
    assert port.steps_per_epoch() == ref.steps_per_epoch() == 2
    assert port.train.cyclicity_report["fraction_cyclic"] == 1.0
    val_p, val_r = list(port.val_batches()), list(ref.val_batches())
    assert [v.shape[0] for v in val_p] == [v.shape[0] for v in val_r] == [4, 1]


# ---------------------------------------------------------------------------
# the trainer and the command line
# ---------------------------------------------------------------------------


def test_trainer_fit_on_cpu(tmp_path):
    """Trainer.fit end to end at a tiny size on the CPU: steps stop at
    max_steps mid-epoch, one validation per epoch, every parameter moves, and
    no kernel launches (CPU tensors take the plain versions)."""
    _, _, model = _pair(2, "open", 0.0, "float32")
    before = [p.detach().clone() for p in model.parameters()]
    cfg = copy.deepcopy(TRAINING_PRESETS["quick"])
    cfg["n_train_samples"], cfg["n_val_samples"] = 12, 6
    data = CyclicDataModule({**CYCLIC_SPRITES, "train_path": str(tmp_path / "none.npz"),
                             "test_path": str(tmp_path / "none.npz"), "sequence_length": 4,
                             "image_size": [16, 16]}, seed=1)
    data.setup(cfg)
    launches = (chol_bundle.launches, iaf_chain_fwd.launches, iaf_chain_bwd.launches)
    trainer = Trainer(model, data, cfg, run_dir=tmp_path / "run", seed=0, device="cpu")
    result = trainer.fit(max_epochs=3, max_steps=5)  # 3 steps per epoch at batch 4
    assert result["steps"] == 5 and result["epochs_run"] == 2
    step_records = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl")
                    .read_text().splitlines() if '"lr"' in line]
    assert len(result["history"]) == 2 and [r["_step"] for r in step_records] == [1, 2, 3, 4, 5]
    for summary in result["history"]:
        assert all(np.isfinite(v) for v in summary.values())
    assert set(result["history"][0]) >= {"val/loss", "train/loss", "train/grad_norm"}
    assert (chol_bundle.launches, iaf_chain_fwd.launches, iaf_chain_bwd.launches) == launches
    # every parameter moves (the log-variance head, which the Riemannian KL
    # does not read, by weight decay alone), except a zero-initialised one
    # that gets no gradient
    assert all(not torch.equal(a, p.detach()) or not a.any()
               for a, p in zip(before, model.parameters()))
    assert np.isfinite(trainer.evaluate("test", weights="live")["loss"])


def test_training_entry_point_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would train on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--steps", "1"])


def test_params_to_numpy_round_trip():
    model = create_model(PRESETS["riemannian_flow_vae"])
    params = params_to_numpy(model)
    assert params["encoder"]["hidden_0"]["kernel"].shape == (12288, 512)
    assert len(params["flows"]) == 8 and sorted(params["flows"][0][0]) == [
        "b0", "b1", "b2", "b3", "w0", "w1", "w2", "w3"]
    state = from_jax_variables({"params": params})
    assert all(torch.equal(state[k], v) for k, v in model.state_dict().items())


def test_unported_training_options_raise():
    """remat_decode and fused_decode_mse are ported (tests/test_torch_fast.py
    holds them against JAX), and so are dropout (tests/test_torch_convnets.py)
    and the flows' Jacobi fixed-point blocks (tests/test_torch_fixedpoint.py
    holds the model against JAX): each builds a model with its knob set; the
    fixed-point model's chain is the plain Jacobi chain at that count."""
    for knob in ("remat_decode", "fused_decode_mse"):
        model = create_model({**PRESETS["riemannian_flow_vae"], knob: True, "pretrained": {}})
        assert getattr(model, knob) is True
    model = create_model({**PRESETS["riemannian_flow_vae"], "pretrained": {},
                          "encoder": {"architecture": "mlp", "dropout": 0.1}})
    assert model.encoder.dropout == 0.1
    model = create_model({**PRESETS["riemannian_flow_vae"], "pretrained": {},
                          "flow_fixedpoint_iters": 2})
    assert model.flows.fixedpoint_iters == 2
    z0 = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32))
    chain = [model.flows.flows[min(t, 7)] for t in range(7)]
    with torch.no_grad():
        z_seq, lds = apply_temporal_flows(model.flows, z0, 8)
        z_ref, ld_ref = iaf_chain_fwd_ref(z0, *stack_chain(chain), fp_iters=2)
    assert torch.equal(z_seq[:, 1:], z_ref.transpose(0, 1)) and torch.equal(lds, ld_ref.T)
