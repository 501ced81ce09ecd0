"""The shipped conv and deep-MLP model configs (``conf/model/cnn_rlvae.yaml``,
``resnet_rlvae.yaml``, ``mlp_rlvae.yaml``) in the port against the JAX
package on the CPU, with their BatchNorm state carried through the model,
trainer, checkpoints, conversion and serving.

Each config is composed from ``conf/`` and narrowed: 16x16 frames, 2 flows
of hidden width 32 at the near-identity flow init (log-sigma bias 0), cnn
``layers`` [4, 8] / [8, 4], resnet [8, 16] / [16, 8] with one block per
stage, mlp [32, 16] / [16, 32]; fp32 nets, dropout 0, no pretrained nets;
the K=50 metric of the config.  Both models get the same variables: the
JAX model's shapes (``jax.eval_shape`` of its ``init``) filled with seeded
draws for the nets (kernels N(0, 1/fan_in), biases, BatchNorm scales and
running statistics away from their init) and JAX's own flow init, carried
to the port through ``convert.checkpoint_from_jax``.  One jitted JAX
program gives the eval forward and one step of JAX's ``_step_body`` (the
body of ``make_train_step``), on eps = normal(split(key)[0], (B, D)).

Tolerances (fp32, sums in another order): eval mu, log_var and losses
rtol 1e-5 (atol 1e-5); z and the reconstruction within 1e-5 of their
scale; the step's losses and grad_norm rtol 1e-4; parameters after the step
atol 2e-5 (2% of one Adam step of lr 1e-3: a sign flip of an update or a
missing decay shows as ~1e-3) wherever Adam's input g + wd p is above 1e-4
of its largest over the model, and within 2 lr elsewhere (a conv bias just before
a BatchNorm has no true gradient: its rounding picks the update's sign, on
either side); Adam's moments within 1e-4 of their largest over the model; BatchNorm
statistics 1e-5.

Then the state's round trip: JAX's variables -> the port -> JAX's trees
bit for bit (``params_to_numpy``, ``stats_to_numpy``,
``from_jax_variables``); a Trainer run's ``last`` and ``best`` slots with
the BatchNorm buffers bit for bit, resumed and evaluated; one tiny
``experiment.main(["model=cnn_rlvae", ...])`` run on the CPU served by
``ModelManager.from_run``; and the MLP artifacts' warning with both nets
left at their init.
"""

import copy
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.models.factory import create_model as jax_create_model
from rlvae_tpu.train import optim as jopt
from rlvae_tpu.train.trainer import _step_body
from rlvae_tpu_torch import ModelManager, experiment
from rlvae_tpu_torch.config import compose
from rlvae_tpu_torch.convert import (
    checkpoint_from_jax,
    from_jax_variables,
    params_to_numpy,
    stats_to_numpy,
)
from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
from rlvae_tpu_torch.models import create_model
from rlvae_tpu_torch.nets import DropoutMasks
from rlvae_tpu_torch.train import TRAINING_PRESETS, Trainer, adam_state, make_optimizer
from rlvae_tpu_torch.train import make_train_step

CONF = Path(__file__).resolve().parents[1] / "conf"
LR, WD, B, T = 1e-3, 1e-4, 4, 4
NARROW = {
    "cnn_rlvae": ["model.encoder.layers=[4,8]", "model.decoder.layers=[8,4]"],
    "resnet_rlvae": ["model.encoder.layers=[8,16]", "model.decoder.layers=[16,8]",
                     "model.encoder.num_blocks=[1]", "model.decoder.num_blocks=[1]"],
    "mlp_rlvae": ["model.encoder.hidden_dims=[32,16]", "model.decoder.hidden_dims=[16,32]"],
}
COMMON = ["model.input_dim=[3,16,16]", "model.n_flows=2", "model.flow_hidden_size=32",
          "+model.flow_log_var_bias_init=0.0", "model.encoder.dtype=float32",
          "model.decoder.dtype=float32", "model.encoder.dropout=0.0",
          "model.decoder.dropout=0.0", "model.pretrained.encoder_path=null",
          "model.pretrained.decoder_path=null"]
LOSS_KEYS = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty")


def _config(name, extra=()):
    return compose(CONF, "config", [f"model={name}", *COMMON, *NARROW[name], *extra])["model"]


def _draw(tree, rng):
    """Seeded values in the shapes of a Flax net's params or batch_stats."""
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


def _variables(jm):
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jm.init, key)
    rng = np.random.default_rng(1)
    flows = jax.tree_util.tree_map(np.asarray, jm.flow_config.init(jax.random.PRNGKey(2)))
    return {"params": {"encoder": _draw(shapes["params"]["encoder"], rng),
                       "decoder": _draw(shapes["params"]["decoder"], rng), "flows": flows},
            "stats": {k: _draw(shapes["stats"][k], rng) for k in ("encoder", "decoder")}}


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _scaled(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.fixture(scope="module", params=sorted(NARROW))
def pair(request):
    """(name, config, JAX model, its variables, JAX's eval forward, step
    results and optimizer state, inputs)."""
    cfg = _config(request.param)
    jm = jax_create_model(cfg)
    jv = _variables(jm)
    x = np.random.default_rng(3).uniform(size=(B, T, 3, 16, 16)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    opt = jopt.make_optimizer(LR, WD)
    opt_state = opt.init(jv["params"])

    def run(v, s, x, key):
        evaluated = jm.forward(v, x, key, train=False)
        nv, ns, metrics = _step_body(jm, opt, v, s, x, key)
        return dict(evaluated), nv, ns, metrics

    out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(jv, opt_state, jnp.asarray(x), key))
    eps = np.asarray(jax.random.normal(jax.random.split(key)[0], (B, 16)))
    return {"name": request.param, "cfg": cfg, "jm": jm, "jv": jv, "opt_state": opt_state,
            "eval": out[0], "stepped": out[1], "opt_after": out[2], "metrics": out[3],
            "x": x, "eps": eps}


def _port(pair):
    """The port's model on JAX's variables, through a converted JAX slot."""
    pm = create_model(pair["cfg"])
    slot = checkpoint_from_jax({"variables": pair["jv"], "step": 0, "val_loss": 1.0})
    pm.load_state_dict(slot["params"])
    return pm


def test_eval_forward_matches_jax(pair):
    pm = _port(pair)
    with torch.no_grad():
        got = pm(torch.from_numpy(pair["x"]), eps=torch.from_numpy(pair["eps"]))
    want = pair["eval"]
    for k in ("mu", "log_var", *LOSS_KEYS):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("z", "recon_x"):
        _scaled(got[k].numpy(), want[k], 1e-5, k)
    assert type(pm.encoder).__name__ == type(pair["jm"].encoder).__name__


def test_train_step_matches_jax_params_adam_and_stats(pair):
    pm = _port(pair)
    opt = make_optimizer(pm.parameters(), LR, WD)
    step = make_train_step(pm, opt)
    metrics = {k: float(v) for k, v in step(torch.from_numpy(pair["x"]),
                                           torch.from_numpy(pair["eps"])).items()}
    for k, v in metrics.items():
        np.testing.assert_allclose(v, pair["metrics"][k], rtol=1e-4, atol=1e-5, err_msg=k)
    want = checkpoint_from_jax({"variables": pair["stepped"], "step": 1, "val_loss": 1.0,
                                "epoch": 0, "opt_leaves": _leaves(pair["opt_after"])})
    # Adam's first update is -lr * u / (|u| + eps) for u = g + wd p: where u
    # is at the level of the gradients' rounding (a bias just before a
    # BatchNorm has no true gradient) its sign is the rounding's, on either side
    u = {k: v["exp_avg"].numpy() / 0.1 for k, v in want["optimizer"]["state"].items()}
    u_scale = max(np.abs(v).max() for v in u.values())
    for name, p in pm.named_parameters():
        sure = np.abs(u[name]) > 1e-4 * u_scale
        err = np.abs(p.detach().numpy() - want["params"][name].numpy())
        assert err[sure].max(initial=0) <= 2e-5, name
        assert err.max() <= 2 * LR + 2e-5, name
    got_stats, want_stats = stats_to_numpy(pm), pair["stepped"]["stats"]
    assert jax.tree_util.tree_structure(got_stats) == jax.tree_util.tree_structure(want_stats)
    for a, b in zip(_leaves(got_stats), _leaves(want_stats)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    if pair["name"] != "mlp_rlvae":
        moved = [not np.array_equal(a, b) for a, b in
                 zip(_leaves(got_stats), _leaves(pair["jv"]["stats"]))]
        assert all(moved)
    got = adam_state(pm, opt)
    assert got["lr"] == pytest.approx(want["optimizer"]["lr"])
    assert set(got["state"]) == set(want["optimizer"]["state"]) == {
        n for n, _ in pm.named_parameters()}
    for k in ("exp_avg", "exp_avg_sq"):  # within 1e-4 of the model's largest
        scale = max(float(st[k].abs().max()) for st in want["optimizer"]["state"].values())
        for name, st in want["optimizer"]["state"].items():
            assert float(got["state"][name]["step"]) == float(st["step"]) == 1.0
            err = float((got["state"][name][k] - st[k]).abs().max())
            assert err <= 1e-4 * scale, f"{name} {k}: {err} > 1e-4 * {scale}"


def test_state_round_trip_is_exact(pair):
    """JAX variables -> the port (a converted slot) -> JAX's trees, bit for
    bit, and the port's state dict -> JAX trees -> the port's state dict."""
    pm = _port(pair)
    jv = pair["jv"]
    for got, want in ((params_to_numpy(pm), jv["params"]), (stats_to_numpy(pm), jv["stats"])):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(a, b)
    again = from_jax_variables({"params": params_to_numpy(pm), "stats": stats_to_numpy(pm)})
    state = pm.state_dict()
    assert set(again) == set(state)
    assert all(torch.equal(again[k], state[k]) for k in state)
    n_stats = sum(a.size for a in _leaves(jv["stats"]))
    assert sum(b.numel() for n, b in pm.named_buffers()
               if n.startswith(("encoder.", "decoder."))) == n_stats
    assert pm.param_count() == pair["jm"].param_count(jv)


# ---------------------------------------------------------------------------
# the trainer, checkpoints and serving with BatchNorm state
# ---------------------------------------------------------------------------


def _trainer(run_dir, model, steps=2):
    cfg = copy.deepcopy(TRAINING_PRESETS["default"])
    cfg["data"]["batch_size"] = 2
    cfg["n_train_samples"], cfg["n_val_samples"] = 2 * steps, 2
    cfg["trainer"]["max_epochs"] = 2
    data = CyclicDataModule({**CYCLIC_SPRITES, "image_size": [16, 16], "sequence_length": T,
                             "synthetic_n_test": 2}, seed=0)
    data.setup(cfg)
    return Trainer(model, data, cfg, run_dir=run_dir, seed=0, device="cpu")


def _buffers(model):
    """The nets' BatchNorm statistics."""
    return {k: v.clone() for k, v in model.named_buffers()
            if k.startswith(("encoder.", "decoder."))}


def test_trainer_checkpoints_carry_batchnorm_state(tmp_path):
    """Dropout on (the registry's 0.1): a fit moves the running statistics;
    ``last`` and ``best`` hold them bit for bit; a resumed trainer starts
    from them; ``evaluate()`` reads ``best`` and leaves the live ones."""
    cfg = _config("cnn_rlvae", ["model.encoder.dropout=0.1", "model.decoder.dropout=0.1"])
    model = create_model(cfg)
    assert model.encoder.dropout == model.decoder.dropout == 0.1
    before = _buffers(model)
    trainer = _trainer(tmp_path, model)
    trainer.fit(max_epochs=1)
    after = _buffers(model)
    assert all(not torch.equal(before[k], after[k]) for k in before)
    last = trainer.checkpoints.restore("last")["params"]
    assert set(last) == set(model.state_dict())
    assert all(torch.equal(last[k], after[k]) for k in after)
    assert all(k not in trainer.checkpoints.restore("last")["optimizer"]["state"]
               for k in after)  # Adam never sees the buffers

    resumed_model = create_model(cfg, seed=5)
    resumed = _trainer(tmp_path, resumed_model)
    seen, step = [], resumed.train_step

    def first(x, noise):
        if not seen:
            seen.append(_buffers(resumed_model))
        return step(x, noise)

    resumed.train_step = first
    resumed.fit(resume=True)
    assert seen and all(torch.equal(seen[0][k], after[k]) for k in after)
    live = _buffers(resumed_model)
    best = resumed.checkpoints.restore("best")["params"]
    result = resumed.evaluate()
    assert np.isfinite(result["loss"])
    assert all(torch.equal(live[k], v) for k, v in _buffers(resumed_model).items())
    assert any(not torch.equal(best[k], live[k]) for k in live)


def test_eval_step_and_train_dropout_masks(tmp_path):
    """Validation runs the nets in eval mode: the same noise gives the same
    metrics twice and moves no statistic; a train forward draws its dropout
    masks from the generator it is given, the same seed the same loss."""
    cfg = _config("cnn_rlvae", ["model.encoder.dropout=0.1", "model.decoder.dropout=0.1"])
    model = create_model(cfg)
    x = torch.rand(2, T, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    eps = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    before = _buffers(model)
    with torch.no_grad():
        a, b = model(x, eps=eps), model(x, eps=eps)
    assert torch.equal(a.loss, b.loss)
    assert all(torch.equal(before[k], v) for k, v in _buffers(model).items())
    losses = []
    for seed in (3, 3, 4):
        model.load_state_dict({**model.state_dict(), **before})
        with torch.no_grad():
            losses.append(model(x, eps=eps, train=True,
                                dropout=torch.Generator().manual_seed(seed)).loss)
    assert torch.equal(losses[0], losses[1]) and not torch.equal(losses[0], losses[2])
    with pytest.raises(ValueError, match="generator"):
        model(x, eps=eps, train=True)


def test_experiment_cnn_run_served_from_run(tmp_path):
    """``python -m rlvae_tpu_torch.experiment model=cnn_rlvae ...`` on the
    CPU, narrowed, then ``ModelManager.from_run``: its ``reconstruct`` is the
    eval forward of a model loaded from ``best`` by hand, BatchNorm state
    included, and ``get_model_info`` counts parameters only."""
    run_dir = tmp_path / "run"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        experiment.main(["model=cnn_rlvae", "training=quick", "training.trainer.accelerator=cpu",
                         "training.trainer.max_epochs=1", "training.n_train_samples=4",
                         "training.n_val_samples=2", "training.data.batch_size=2",
                         "data.image_size=[16,16]", "data.sequence_length=4",
                         "data.synthetic_n_train=8", "data.synthetic_n_test=4",
                         "model.n_flows=2", "model.flow_hidden_size=16",
                         *NARROW["cnn_rlvae"], "visualization=minimal",
                         "visualization.frequency=0", f"run.dir={run_dir}"])
    manager = ModelManager.from_run(run_dir, device="cpu")
    best = torch.load(run_dir / "checkpoints" / "best" / "state.pt", weights_only=True)["params"]
    assert any(k.endswith(".var") for k in best)
    state = manager.model.state_dict()
    assert all(torch.equal(state[k], best[k]) for k in best)
    x = np.random.default_rng(4).uniform(size=(2, T, 3, 16, 16)).astype(np.float32)
    recon = manager.reconstruct(x, seed=2)
    assert recon.shape == x.shape and np.isfinite(recon).all()
    np.testing.assert_array_equal(manager.reconstruct(x, seed=2), recon)
    info = manager.get_model_info()
    assert info["architecture"]["encoder"] == "CNNEncoder"
    assert info["parameter_count"] == sum(p.numel() for p in manager.model.parameters())


def test_mismatched_artifacts_warn_and_keep_both_nets_at_init():
    """As JAX's ``RlVAE.init``: the configs' MLP artifacts do not fit a cnn
    net, and an encoder that fits is not loaded either when the decoder's
    artifact does not fit (both or neither)."""
    cfg = compose(CONF, "config", ["model=cnn_rlvae", "model.n_flows=2", "model.flow_hidden_size=16",
                                   *NARROW["cnn_rlvae"]])["model"]
    bare = {**cfg, "pretrained": {**cfg["pretrained"], "encoder_path": None,
                                  "decoder_path": None}}
    for config, kind in ((cfg, "cnn"), (None, "mlp")):
        if config is None:  # the 512-wide encoder fits; a 256-wide decoder does not
            config = compose(CONF, "config", ["model=riemannian_flow_vae", "model.n_flows=2",
                                              "model.flow_hidden_size=16",
                                              "model.decoder.hidden_dims=[256]"])["model"]
            bare = {**config, "pretrained": {**config["pretrained"], "encoder_path": None,
                                             "decoder_path": None}}
        with pytest.warns(UserWarning, match="pretrained components not loaded"):
            model = create_model(config, seed=3)
        want = create_model(bare, seed=3).state_dict()
        got = model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), kind


def test_remat_decode_recomputes_on_the_first_pass_masks():
    """``remat_decode`` with decoder dropout: the checkpointed decode's
    recompute reuses the masks of its first pass, so loss and gradients are
    the plain path's and no extra mask is drawn."""
    cfg = _config("mlp_rlvae", ["model.encoder.dropout=0.1", "model.decoder.dropout=0.1"])
    plain, remat = create_model(cfg), create_model({**cfg, "remat_decode": True})
    remat.load_state_dict(plain.state_dict())
    x = torch.rand(2, T, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    eps = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    drawn, losses = [], []
    for model in (plain, remat):
        masks = DropoutMasks(torch.Generator().manual_seed(2), record=True)
        out = model(x, eps=eps, train=True, dropout=masks)
        out.loss.backward()
        drawn.append(masks.drawn)
        losses.append(out.loss.detach())
    assert remat.remat_decode and len(drawn[0]) == len(drawn[1]) == 4  # 2 hidden layers each
    assert all(torch.equal(a, b) for a, b in zip(*drawn))
    torch.testing.assert_close(losses[1], losses[0], rtol=1e-6, atol=0)
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-5, atol=1e-6, msg=name)
