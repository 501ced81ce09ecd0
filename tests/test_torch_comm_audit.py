"""The port's collectives, their audit, the one-rank world, and a world of
4 ranks with its BatchNorm step, on the CPU.

- The counted wrappers (``parallel.collectives``) count calls and JAX's
  payloads (the reduced tensor, the gathered output, the broadcast tensor)
  in a gloo world of one rank, and nothing without a world.
- A Trainer in a world of one rank takes the data-parallel path (one flat
  all-reduce per step, exactly ``comm_audit.step_plan``) and trains bit for
  bit as the Trainer without a world: one rank reduces nothing.
- ``python -m rlvae_tpu_torch.parallel.comm_audit`` reports the DP and
  DP x TP layouts of one ``dp_verify`` run (with ``dp_verify`` replaced by
  a fake).
- A world of 4 gloo ranks (``dp_verify``, as
  ``tests/test_torch_data_parallel.py`` runs the world of 2, with its
  checks): JAX's DP x TP parity model in the 4 x 1 and 2 x 2 layouts, one
  epoch; step 1 of 2 x 2 against JAX's ``make_train_step`` under
  ``shard_params`` on a 2 x 2 mesh of the conftest's CPU devices; every
  step against the port's plain step; the epoch rows against JAX's
  4-process and 2-process staging; the collectives against JAX's
  invariants.
- In the same world, the narrowed ``cnn_rlvae`` (the convnet tests' 16x16
  cut, fp32 nets, no dropout) stepped over the 4 ranks from JAX's
  variables, on JAX-drawn noise per shard: every rank's BatchNorm running
  statistics after the step equal the mean over the shards of JAX's
  ``state_updates`` of each shard's train forward (JAX's ``pmean`` of
  ``_step_body``), atol 1e-5.
"""

import copy
import json
from datetime import timedelta
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rlvae_tpu.models.factory import create_model as jax_create_model
from rlvae_tpu_torch.config import compose
from rlvae_tpu_torch.convert import from_jax_variables, stats_to_numpy
from rlvae_tpu_torch.data import CYCLIC_SPRITES, CyclicDataModule
from rlvae_tpu_torch.models import create_model
from rlvae_tpu_torch.parallel import comm_audit, dp_verify
from rlvae_tpu_torch.parallel.collectives import CommTally, all_gather, all_reduce, broadcast
from rlvae_tpu_torch.train import TRAINING_PRESETS, Trainer
from tests.test_torch_data_parallel import (
    _jax_step,
    check_collectives,
    check_epoch_rows,
    check_jax_step,
    check_replays,
    run_world,
)

CONF = Path(__file__).resolve().parents[1] / "conf"
CNN_CUT = ["model=cnn_rlvae", "model.input_dim=[3,16,16]", "model.n_flows=2",
           "model.flow_hidden_size=32", "+model.flow_log_var_bias_init=0.0",
           "model.encoder.dtype=float32", "model.decoder.dtype=float32",
           "model.encoder.layers=[4,8]", "model.decoder.layers=[8,4]",
           "model.encoder.dropout=0.0", "model.decoder.dropout=0.0",
           "model.pretrained.encoder_path=null", "model.pretrained.decoder_path=null"]
SMALL_CFG = {"input_dim": [3, 8, 8], "latent_dim": 16, "n_flows": 2, "flow_hidden_size": 32,
             "posterior": {"type": "gaussian"}, "sampling": {"use_riemannian": False},
             "pretrained": {}}
WORLD, LAYOUTS, EPOCHS = 4, (1, 2), 1
CNN_BATCH, CNN_T = 8, 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of 4 ranks with the narrowed cnn_rlvae's step; JAX's 2 x 2
    step and the mean of its cnn shards' BatchNorm updates, computed while
    the world runs."""
    out = tmp_path_factory.mktemp(f"dp{WORLD}")
    config = compose(CONF, "config", CNN_CUT)["model"].to_dict()
    jcm = jax_create_model(config)
    jcv = jax.tree_util.tree_map(np.asarray, jax.jit(jcm.init)(jax.random.PRNGKey(0)))
    x = np.random.default_rng(0).uniform(size=(CNN_BATCH, CNN_T, 3, 16, 16)).astype(np.float32)
    keys = [jax.random.PRNGKey(200 + d) for d in range(WORLD)]
    eps = [np.asarray(jax.random.normal(jax.random.split(k)[0],
                                        (CNN_BATCH // WORLD, jcm.latent_dim))) for k in keys]
    (out / "cnn.json").write_text(json.dumps(config))
    torch.save(from_jax_variables(jcv), out / "cnn.pt")
    np.savez(out / "cnn_inputs.npz", x=x, noise=np.concatenate(eps)[None].astype(np.float32))

    def reference(jm, jv, inp):
        step = _jax_step(jm, jv, inp["x"], inp["keys"][0], WORLD, 2)
        forward = jax.jit(lambda v, xs, k: jcm.forward(v, xs, k, train=True)["state_updates"])
        updates = [forward(jcv, xs, k) for xs, k in zip(np.split(x, WORLD), keys)]
        bn = jax.tree_util.tree_map(lambda *u: np.mean([np.asarray(v) for v in u], 0), *updates)
        return step, bn

    summary, inp, (step, bn), pbytes = run_world(out, WORLD, LAYOUTS, EPOCHS, reference,
                                                 "cnn@1")
    return {"out": out, "summary": summary, "inputs": inp, "jax": step, "jax_bn": bn,
            "param_bytes": pbytes, "cnn_config": config}


def test_dp_tp_step_matches_jax(world):
    check_jax_step(world["out"], "mp2", world["jax"])


@pytest.mark.parametrize("layout", ["1", "2"])
def test_every_step_matches_the_plain_step(world, layout):
    check_replays(world["summary"], layout)


def test_epoch_rows_are_jax_multiprocess_staging(world):
    check_epoch_rows(world["out"], world["summary"], world["inputs"], WORLD, LAYOUTS, EPOCHS)


def test_step_collectives_keep_jax_invariants(world):
    check_collectives(world["summary"], world["param_bytes"])


def test_collectives_count_nothing_without_a_world():
    tally = CommTally()
    x = torch.ones(3)
    assert all_reduce(x, None, tally=tally) is x and all_gather(x, None, tally=tally) is x
    broadcast(x, tally=tally)
    assert all(v == {"count": 0, "bytes": 0} for v in tally.snapshot().values())
    model = create_model(SMALL_CFG)
    plan = comm_audit.step_plan(model, None, None)
    assert all(v == {"count": 0, "bytes": 0} for v in plan.values())


def _tiny_fit(tmp_path, name):
    cfg = copy.deepcopy(TRAINING_PRESETS["quick"])
    cfg["trainer"]["accelerator"] = "cpu"
    cfg["n_train_samples"], cfg["n_val_samples"] = 8, 4
    cfg["data"]["batch_size"] = 4
    data = CyclicDataModule({**CYCLIC_SPRITES, "train_path": str(tmp_path / "none.npz"),
                             "test_path": str(tmp_path / "none.npz"), "sequence_length": 4,
                             "image_size": [8, 8], "synthetic_n_test": 8}, seed=1)
    data.setup(cfg)
    trainer = Trainer(create_model(SMALL_CFG, seed=3), data, cfg, run_dir=tmp_path / name,
                      seed=5, device="cpu")
    return trainer, trainer.fit(max_epochs=1)


def test_one_rank_world_counts_and_trains_as_one_process(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0, timeout=timedelta(seconds=60))
    try:
        tally = CommTally()
        group = dist.new_group([0])
        x = torch.arange(6.0)
        all_reduce(x, group, tally=tally)
        gathered = all_gather(x[:2].contiguous(), group, tally=tally)
        broadcast(x, tally=tally)
        assert torch.equal(gathered, x[:2])
        assert tally.snapshot() == {"all-reduce": {"count": 1, "bytes": 24},
                                    "all-gather": {"count": 1, "bytes": 8},
                                    "reduce-scatter": {"count": 0, "bytes": 0},
                                    "broadcast": {"count": 1, "bytes": 24}}
        trainer, in_world = _tiny_fit(tmp_path, "world")
        assert trainer.mesh is not None and trainer.mesh.dp == 1
        world_state = trainer._params()
        plan = comm_audit.step_plan(trainer.model, trainer.optimizer, trainer.mesh)
        one = comm_audit.audit(trainer.train_step, torch.rand(4, 4, 3, 8, 8),
                               trainer.model.draw_posterior_noise(4))
        assert one["total_count"] == 1 and one["collectives"] == plan
    finally:
        dist.destroy_process_group()
    trainer, alone = _tiny_fit(tmp_path, "alone")
    assert trainer.mesh is None
    for key in ("train/loss", "train/grad_norm", "val/loss"):
        assert alone["history"][0][key] == in_world["history"][0][key], key
    for k, v in trainer._params().items():
        assert torch.equal(v, world_state[k]), k


def test_comm_audit_cli_reports_both_layouts(tmp_path, monkeypatch):
    """The CLI runs dp_verify once over the DP and DP x TP layouts (the
    layouts' own checks: ``tests/test_torch_data_parallel.py``) and reports
    each one's collectives and parameter bytes."""
    calls = []

    def fake_main(argv):
        calls.append(argv)
        layout = {"mesh": {}, "collectives": {}, "plan": {}, "param_bytes": 8, "total_bytes": 4}
        (tmp_path / "summary.json").write_text(json.dumps(
            {"ok": True, "layouts": {"1": {**layout, "mesh": {"data": 4, "model": 1}},
                                     "2": {**layout, "mesh": {"data": 2, "model": 2}}}}))
        return 0

    monkeypatch.setattr(dp_verify, "main", fake_main)
    assert comm_audit.main(["--world", "4", "--model-parallel", "2", "--device", "cpu",
                            "--out", str(tmp_path)]) == 0
    argv = calls[0]
    assert argv[argv.index("--model-parallel") + 1] == "1,2"
    assert argv[argv.index("--world") + 1] == "4" and "--epochs" in argv
    report = json.loads((tmp_path / "comm_audit.json").read_text())
    assert report["dp"]["mesh"] == {"data": 4, "model": 1}
    assert report["dp_tp"]["mesh"] == {"data": 2, "model": 2}
    monkeypatch.setattr(dp_verify, "main", lambda argv: 1)
    assert comm_audit.main(["--device", "cpu", "--out", str(tmp_path)]) == 1


def test_cnn_batchnorm_statistics_are_jax_pmean(world):
    bn = world["summary"]["layouts"]["cnn"]
    assert bn["bn_vs_shard_mean_rel"] <= 1e-6 and bn["bn_shard_vs_plain_rel"] <= 1e-5
    model = create_model(world["cnn_config"])
    model.load_state_dict(torch.load(world["out"] / "cnn_steps_state1.pt",
                                     weights_only=True)["params"])
    got, want = stats_to_numpy(model), world["jax_bn"]
    for comp in ("encoder", "decoder"):
        assert set(got[comp]) == set(want[comp]), comp
        for layer, stats in want[comp].items():
            for k, v in stats.items():
                np.testing.assert_allclose(got[comp][layer][k], v, rtol=0, atol=1e-5,
                                           err_msg=f"{comp}.{layer}.{k}")
