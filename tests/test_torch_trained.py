"""The port on the trained JAX weights: the two 50-epoch full-data runs of
``outputs/stable_vs_reference_fulldata`` (``stable``: sampling-direction
flows, volume flow loss; ``reference``: density-direction flows at the
reference init, whose latents reach ~4e14), restored with orbax here in
the test and carried across with ``convert.from_jax_variables`` /
``convert.checkpoint_from_jax``.  Each model is built from its run's
``config.yaml`` ``model`` section on both sides.

Tolerances:

- eval forward at B=2 on JAX's posterior noise, fp32 nets (as
  ``tests/test_torch_model.py``): mu, log_var atol 1e-5; losses rtol 1e-5
  (atol 1e-6); z within 1e-5 of each time step's largest |z|; recon_x atol
  5e-4.  The ``reference`` arm's flows are also held per transition, each
  from the port's own input to it (JAX's ``iaf_forward``), within 1e-5 of
  that step's largest |z|.
- the shipped bf16 nets: mu, log_var, kld_loss and the losses at rtol and
  atol 1e-2, z within 1e-2 of each step's largest |z|, and recon_x by its
  mean |difference| at 1e-2 (bf16 rounds at other places in the two
  frameworks; at the reference arm's latents a saturated pixel may flip
  between 0 and 1).
- one Adam update from ``stable/checkpoints/last`` (JAX's optimizer state
  carried by ``adam_state_from_jax_opt_leaves``) on the same seeded
  gradients against optax's: parameters and both moments within rtol 1e-6
  and atol 1e-9 (fp32; torch and optax order the bias corrections apart),
  the step counts and learning rate equal.
- a port run directory written from the JAX checkpoint reconstructs bit for
  bit as the directly loaded model.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch
import yaml

from rlvae_tpu.flows.iaf import iaf_forward as jax_iaf_forward
from rlvae_tpu.flows.iaf import iaf_masks
from rlvae_tpu.models import create_model as jax_create_model
from rlvae_tpu.train.optim import make_optimizer as jax_make_optimizer
from rlvae_tpu_torch import ModelManager, create_model
from rlvae_tpu_torch.convert import (
    adam_state_from_jax_opt_leaves,
    checkpoint_from_jax,
    from_jax_variables,
    params_to_numpy,
)
from rlvae_tpu_torch.train import CheckpointManager, adam_state, load_adam_state, make_optimizer

RUNS = Path(__file__).resolve().parents[1] / "outputs" / "stable_vs_reference_fulldata"
LOSSES = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty")


def _restore(arm: str, slot: str):
    tree = ocp.PyTreeCheckpointer().restore(str(RUNS / arm / "checkpoints" / slot))
    return jax.tree_util.tree_map(np.asarray, tree)


def _config(arm: str, dtype=None):
    full = yaml.safe_load((RUNS / arm / "config.yaml").read_text())
    model = full["model"]
    if dtype is not None:
        model = {**model, "encoder": {"architecture": "mlp", "dtype": dtype},
                 "decoder": {"architecture": "mlp", "dtype": dtype}}
    return model, full["training"]


@pytest.fixture(scope="module", params=["stable", "reference"])
def arm(request):
    return request.param, _restore(request.param, "best")


def _forward_both(cfg, variables, x, seed):
    jm = jax_create_model(cfg)
    pm = create_model(cfg)
    pm.load_state_dict(from_jax_variables(variables))
    key = jax.random.PRNGKey(seed)
    jo = jax.tree_util.tree_map(np.asarray, dict(jm.forward(variables, jnp.asarray(x), key)))
    # JAX: k_sample = split(key)[0]; eps = normal(k_sample, mu.shape)
    eps = np.array(jax.random.normal(jax.random.split(key)[0], (x.shape[0], 16)))
    with torch.no_grad():
        po = pm.eval()(torch.from_numpy(x), eps=torch.from_numpy(eps))
    return jo, {k: v.float().numpy() for k, v in po.items() if isinstance(v, torch.Tensor)}


def _z_close(got, want, rtol):
    scale = np.abs(want).max(axis=(0, 2), keepdims=True)  # per time step
    np.testing.assert_array_less(np.abs(got - want), np.broadcast_to(rtol * scale + 1e-6,
                                                                       want.shape))


def _inputs(seed):
    return np.random.default_rng(seed).uniform(size=(2, 8, 3, 64, 64)).astype(np.float32)


def test_trained_eval_forward_fp32_matches_jax(arm):
    name, restored = arm
    cfg, _ = _config(name, "float32")
    variables = restored["variables"]
    jo, po = _forward_both(cfg, variables, _inputs(0), seed=7)
    for k in ("mu", "log_var"):
        np.testing.assert_allclose(po[k], jo[k], rtol=0, atol=1e-5, err_msg=k)
    _z_close(po["z"], jo["z"], 1e-5)
    np.testing.assert_allclose(po["recon_x"], jo["recon_x"], rtol=0, atol=5e-4)
    for k in LOSSES:
        np.testing.assert_allclose(po[k], jo[k], rtol=1e-5, atol=1e-6, err_msg=k)
    if name == "reference":  # density-direction flows: each transition from the port's input
        assert np.abs(po["z"]).max() > 1e12  # the exploding latents of SUMMARY.md
        masks = iaf_masks(16, 256, 3)
        for t in range(7):
            flow = variables["params"]["flows"][t]
            y, _ = jax_iaf_forward(flow, masks, jnp.asarray(po["z"][:, t]))
            want = np.asarray(y)
            scale = np.abs(want).max()
            np.testing.assert_array_less(np.abs(po["z"][:, t + 1] - want), 1e-5 * scale + 1e-6)


def test_trained_eval_forward_bf16_matches_jax(arm):
    name, restored = arm
    cfg, _ = _config(name)
    assert "dtype" not in cfg["encoder"]  # the shipped nets: bf16 activations
    jo, po = _forward_both(cfg, restored["variables"], _inputs(1), seed=3)
    for k in ("mu", "log_var") + LOSSES:
        np.testing.assert_allclose(po[k], jo[k], rtol=1e-2, atol=1e-2, err_msg=k)
    _z_close(po["z"], jo["z"], 1e-2)
    assert np.abs(po["recon_x"] - jo["recon_x"]).mean() <= 1e-2


def test_adam_update_from_the_trained_optimizer_state_matches_optax():
    restored = _restore("stable", "last")
    cfg, training = _config("stable")
    params = restored["variables"]["params"]
    leaves = restored["opt_leaves"]
    wd = float(training["optimizer"]["weight_decay"])

    # JAX: the trainer's optimizer, its state rebuilt from the flat leaves
    # as fit(resume=True) does (rlvae_tpu/train/trainer.py:519-524)
    opt = jax_make_optimizer(float(training["optimizer"]["lr"]), wd)
    treedef = jax.tree_util.tree_structure(opt.init(params))
    opt_state = jax.tree_util.tree_unflatten(
        treedef, [leaves[str(i)] for i in range(treedef.num_leaves)])
    rng = np.random.default_rng(11)
    grads = jax.tree_util.tree_map(
        lambda a: rng.normal(scale=1e-2, size=a.shape).astype(np.float32), params)
    updates, new_state = opt.update(grads, opt_state, params)
    new_params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
    new_leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(new_state)]

    pm = create_model(cfg)
    pm.load_state_dict(from_jax_variables(params))
    carried = adam_state_from_jax_opt_leaves(leaves, pm)
    assert carried["lr"] == float(leaves["1"])
    assert len(carried["state"]) == len(list(pm.parameters()))
    assert {float(s["step"]) for s in carried["state"].values()} == {float(restored["step"])}
    slot = checkpoint_from_jax(restored)  # the same state, as a port 'last' slot
    assert sorted(slot) == ["epoch", "optimizer", "params", "step", "val_loss"]
    assert slot["epoch"] == 49 and slot["step"] == 31250
    assert slot["optimizer"]["lr"] == carried["lr"]
    assert all(torch.equal(slot["optimizer"]["state"][n][k], st[k])
               for n, st in carried["state"].items() for k in st)
    torch_opt = make_optimizer(pm.parameters(), 1.0, wd)  # the lr comes with the state
    load_adam_state(pm, torch_opt, carried)
    g = from_jax_variables(grads)
    for name, p in pm.named_parameters():
        p.grad = g[name]
    torch_opt.step()

    got, want = jax.tree_util.tree_leaves(params_to_numpy(pm)), jax.tree_util.tree_leaves(
        new_params)
    assert len(got) == len(want) == 138
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    port, jax_side = adam_state(pm, torch_opt), adam_state_from_jax_opt_leaves(new_leaves, pm)
    assert port["lr"] == jax_side["lr"]
    for name, st in port["state"].items():
        assert float(st["step"]) == float(jax_side["state"][name]["step"]) == restored["step"] + 1
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(st[k].numpy(), jax_side["state"][name][k].numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=f"{name} {k}")


def test_run_dir_from_the_jax_checkpoint_serves_bitwise(tmp_path):
    restored = _restore("stable", "best")
    cfg, _ = _config("stable")
    slot = checkpoint_from_jax(restored)
    assert sorted(slot) == ["params", "step", "val_loss"] and slot["step"] == 31250
    CheckpointManager(tmp_path / "checkpoints").save("best", slot)
    served = ModelManager.from_checkpoint(tmp_path, cfg, "best", device="cpu")
    model = create_model(cfg)
    model.load_state_dict(from_jax_variables(restored["variables"]))
    direct = ModelManager(model, device="cpu")
    x = _inputs(2)
    np.testing.assert_array_equal(served.reconstruct(x, seed=4), direct.reconstruct(x, seed=4))
    assert served.get_model_info()["parameter_count"] == 14_927_392
