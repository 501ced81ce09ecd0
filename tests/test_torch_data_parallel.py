"""The port's data parallelism (and DP x TP) against the JAX package on the CPU.

A world of 2 gloo ranks (subprocesses, through
``rlvae_tpu_torch.parallel.dp_verify``, started before the JAX reference
is computed and read after) trains JAX's DP x TP parity model (3x8x8
frames, latent 16, two flows of width 32, Gaussian posterior) from the JAX
model's variables, on one global batch of 16 with JAX-drawn noise (eps =
normal(split(PRNGKey(100 + i))[0], (16, 16)) at step i), in the 2 x 1 and
1 x 2 layouts, and the fast preset (fused decode+MSE; 3x8x8, two flows of
width 32, the K=50 metric, its seeded init) in the 1 x 2 layout.  The
world of 4 ranks (4 x 1, 2 x 2) and the BatchNorm step are in
``tests/test_torch_comm_audit.py``.

- Step 1 of the 2 x 1 layout against JAX's ``make_train_step`` under a
  2-device ``batch_sharding`` on the conftest's CPU devices: loss rtol
  1e-5, grad_norm rtol 2e-3 and weights rtol 1e-3 / atol 2.5e-3 (JAX's DP x
  TP tolerances, ``tests/test_training.py:244``: one Adam step moves a
  weight by about lr, so the weights alone cannot tell two gradients
  apart), and Adam's first moment, which is 0.1 x step 1's gradient, leaf
  by leaf (relative Frobenius norm, worst leaf <= ``JAX_MOMENT_REL`` =
  2e-2: 4.8e-3 to 5.8e-3 measured in the 1 x 2, 2 x 1, 2 x 2 and 4 x 1
  layouts, the frameworks rounding the nets' bf16 products at other
  places; one shard's gradient in place of the mean reads >= 1.3).
- Every step of every layout against the port's plain step on the whole
  batch from the world's state (the launcher's replay, ``dp_verify.TOL``,
  set from readings against planted faults): loss, step 1's grad_norm,
  the first moment and the update leaf by leaf.
- Each rank's epoch rows against JAX's N-process staging, row for row:
  ``CyclicDataModule(process_index=r, process_count=N)``, the staging shuffle
  ``default_rng(seed + r)`` and the rank's column of JAX's
  ``host_epoch_perm``; the chunked epoch's batches equal the resident
  one's, each epoch step equals the single-process replay, the validation
  split over the ranks equals one process's, and a resume from ``last``
  restores every rank's weights and Adam state bit for bit.
- The collectives of one step: DP all-reduces [1.0, 1.25] x the parameter
  bytes (JAX's ``param_bytes``) in one flat call and gathers nothing; DP x
  TP sends fewer bytes than the parameters in all and gathers less than
  half of them (``tests/test_comm_audit.py:45-93``).
- The fast preset's DP x TP step gathers its decoder's output layer (the
  fused kernel reads it whole) and cuts the gradient back to the slice.
- The pure helpers (``resolve_num_devices``, ``host_epoch_perm``,
  ``usable_local_rows``, ``_param_spec``, the per-rank data slicing of the
  data module and the pipeline) against their JAX counterparts, and the
  refusals: a Trainer asked for more devices outside a world, NCCL with
  two ranks on one device.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.data.cyclic import CyclicDataModule as JaxDataModule
from rlvae_tpu.models import RlVAE as JaxRlVAE
from rlvae_tpu.parallel import batch_sharding, replicate as jax_replicate
from rlvae_tpu.parallel import create_mesh as jax_create_mesh
from rlvae_tpu.parallel.comm_audit import param_bytes as jax_param_bytes
from rlvae_tpu.parallel.mesh import resolve_num_devices as jax_resolve_num_devices
from rlvae_tpu.parallel.multihost import host_epoch_perm as jax_host_epoch_perm
from rlvae_tpu.parallel.sharding import MODEL_AXIS as JAX_MODEL_AXIS
from rlvae_tpu.parallel.sharding import _param_spec as jax_param_spec
from rlvae_tpu.train import optim as jopt
from rlvae_tpu.train import pipelines as jax_pipelines
from rlvae_tpu.train.trainer import make_train_step as jax_make_train_step
from rlvae_tpu_torch.convert import from_jax_variables, params_to_numpy
from rlvae_tpu_torch.data import CyclicDataModule
from rlvae_tpu_torch.data.cyclic import CyclicSequenceDataset, batch_iterator
from rlvae_tpu_torch.models import PRESETS, RlVAE
from rlvae_tpu_torch.parallel import dp_verify
from rlvae_tpu_torch.parallel.launch import check_backend
from rlvae_tpu_torch.parallel.mesh import Mesh, resolve_num_devices
from rlvae_tpu_torch.parallel.multihost import host_epoch_perm, usable_local_rows
from rlvae_tpu_torch.parallel.sharding import MODEL_AXIS, _param_spec
from rlvae_tpu_torch.train import TRAINING_PRESETS, Trainer, pipelines
from rlvae_tpu_torch.train.trainer import local_noise

B, T, D, STEPS, SEED, WORLD, EPOCHS = 16, 4, 16, 2, 0, 2, 2
OPT = TRAINING_PRESETS["default"]["optimizer"]
TOL = dp_verify.TOL
JAX_TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 2e-3, "param_rtol": 1e-3, "param_atol": 2.5e-3}
JAX_MOMENT_REL = 2e-2
LAYOUTS = (1, 2)  # model-axis sizes run in the world
DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
FAST = {**PRESETS["riemannian_flow_vae_fast"], "input_dim": [3, 8, 8], "n_flows": 2,
        "flow_hidden_size": 32,
        "pretrained": {"metric_path": str(DATA / "metric_T0.7_scaled.npz")}}


def _inputs():
    rng = np.random.default_rng(SEED)
    keys = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]
    noise = np.stack([np.asarray(jax.random.normal(jax.random.split(k)[0], (B, D)))
                      for k in keys]).astype(np.float32)
    return {"x": rng.uniform(size=(B, T, 3, 8, 8)).astype(np.float32), "noise": noise,
            "train": rng.uniform(size=(16, T, 3, 8, 8)).astype(np.float32),
            "val": rng.uniform(size=(13, T, 3, 8, 8)).astype(np.float32), "keys": keys}


def _jax_step(jm, jv, x, key, n_dev, mp):
    """JAX's step on an n_dev-device mesh: its weights, first moment and metrics."""
    from rlvae_tpu.parallel import shard_params as jax_shard_params

    opt = jopt.make_optimizer(OPT["lr"], OPT["weight_decay"])
    mesh = jax_create_mesh(n_devices=n_dev, model_parallel=mp)
    place = (lambda t: jax_shard_params(mesh, t)) if mp > 1 else (
        lambda t: jax_replicate(mesh, t))
    v = place(jax.tree_util.tree_map(jnp.array, jv))
    o = place(opt.init(jax.tree_util.tree_map(jnp.array, jv["params"])))
    v1, o1, m1 = jax_make_train_step(jm, opt)(v, o, jax.device_put(jnp.asarray(x),
                                                                   batch_sharding(mesh)), key)
    mu = next(s.mu for s in jax.tree_util.tree_leaves(o1, is_leaf=lambda t: hasattr(t, "mu"))
              if hasattr(s, "mu"))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return as_np(v1["params"]), as_np(mu), {k: float(v) for k, v in m1.items()}


def _port_state(path: Path):
    """The JAX-shaped weights and Adam first moment of a saved world state."""
    state = torch.load(path, weights_only=True)
    model = RlVAE(**dp_verify.SMALL)
    model.load_state_dict(state["params"])
    params = params_to_numpy(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state["optimizer"]["state"][name]["exp_avg"])
    return params, params_to_numpy(model)


def run_world(out: Path, world: int, layouts, epochs: int, reference, extra: str = ""):
    """A dp_verify world of ``world`` CPU ranks on the small model from JAX's
    variables (``inputs.npz`` and ``init.pt`` written here; ``extra``
    models' files written by the caller), with ``reference(jm, jv, inp)``
    computed while it runs: (summary, inputs, the reference's result,
    JAX's parameter bytes)."""
    inp = _inputs()
    jm = JaxRlVAE(**dp_verify.SMALL)
    jv = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), n_obs=T))
    np.savez(out / "inputs.npz", model="small", epoch_batch=np.int64(8),
             **{k: v for k, v in inp.items() if k != "keys"})
    torch.save(from_jax_variables(jv), out / "init.pt")
    argv = ["--world", str(world), "--model-parallel", ",".join(map(str, layouts)),
            "--device", "cpu", "--out", str(out), "--epochs", str(epochs), "--seed", str(SEED),
            "--steps", str(STEPS), "--extra", extra, "--timeout", "240"]
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(dp_verify.main, argv)
        ref = reference(jm, jv, inp)
        rc = run.result(timeout=300)
    summary = json.loads((out / "summary.json").read_text())
    assert rc == 0 and summary["ok"], summary
    return summary, inp, ref, jax_param_bytes(jv["params"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's out directory, the launcher's summary, the inputs and
    JAX's 2 x 1 step (computed while the world runs)."""
    out = tmp_path_factory.mktemp(f"dp{WORLD}")
    (out / "fast.json").write_text(json.dumps(FAST))
    summary, inp, ref, pbytes = run_world(
        out, WORLD, LAYOUTS, EPOCHS,
        lambda jm, jv, inp: _jax_step(jm, jv, inp["x"], inp["keys"][0], WORLD, 1), "fast@2")
    return {"out": out, "summary": summary, "inputs": inp, "jax": ref, "param_bytes": pbytes}


def check_jax_step(out: Path, tag: str, jax_ref) -> None:
    """Step 1 of a layout against JAX's: loss, grad_norm and weights at JAX's
    tolerances, the first moment leaf by leaf."""
    jparams, jmu, jmet = jax_ref
    got = np.load(out / f"rank0_{tag}.npz")["metrics"][0]
    assert abs(got[0] - jmet["loss"]) <= JAX_TOL["loss_rtol"] * abs(jmet["loss"]), got
    assert abs(got[5] - jmet["grad_norm"]) <= JAX_TOL["grad_norm_rtol"] * jmet["grad_norm"]
    params, mu = _port_state(out / f"{tag}_steps_state1.pt")
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a, b, rtol=JAX_TOL["param_rtol"], atol=JAX_TOL["param_atol"])
    rel = [np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
           for a, b in zip(jax.tree_util.tree_leaves(mu), jax.tree_util.tree_leaves(jmu))]
    assert len(rel) == len(jax.tree_util.tree_leaves(jmu)) and max(rel) <= JAX_MOMENT_REL, rel


def check_replays(summary, layout: str) -> None:
    """The launcher replayed every step from the world's state on the whole
    batch; the layout's figures are within ``dp_verify.TOL``."""
    found = summary["layouts"][layout]
    for plain in (found["steps_vs_plain"], (found.get("epochs") or {}).get("vs_replay")):
        if plain is None:
            continue
        assert plain["loss_rel"] <= TOL["loss_rtol"], plain
        assert plain["grad_norm_rel"] <= TOL["grad_norm_rtol"], plain
        assert plain["exp_avg_rel"] <= TOL["exp_avg_rel"], plain
        assert plain["update_rel"] <= TOL["update_rel"], plain
        assert len(plain["exp_avg_rel_per_step"]) == len(plain["grad_norm_rel_per_step"]) > 0


def check_epoch_rows(out: Path, summary, inp, world: int, layouts, epochs: int) -> None:
    """Each rank's epoch rows against JAX's N-process staging."""
    data_cfg = dp_verify.data_config(out, inp)
    for mp in layouts:
        dp = world // mp
        layout = summary["layouts"][str(mp)]
        assert dp == 1 or (layout["rows_equal_host_epoch_perm"]
                           and layout["chunked_equals_resident"])
        assert layout["resume_equal"]
        cfg = dp_verify.training_config(dp, mp, 8, len(inp["train"]), len(inp["val"]))
        for r in range(world):
            jdm = JaxDataModule(data_cfg, seed=SEED, process_index=r // mp, process_count=dp)
            jdm.setup(cfg)
            rows = jdm.train.data
            steps = (len(rows) * dp) // 8
            if dp == 1:  # JAX's one-device epoch: its data module's (native) batches
                want = np.concatenate([np.stack(list(jdm.train_batches(e)))
                                       for e in range(epochs)])
            else:
                rows = rows[np.random.default_rng(SEED + r // mp).permutation(len(rows))]
                want = np.concatenate([rows[jax_host_epoch_perm(
                    SEED, e, steps, 8 // dp, len(rows), dp)[:, r // mp]] for e in range(epochs)])
            got = np.load(out / f"rank{r}_mp{mp}.npz")["ex"]
            assert got.shape == want.shape and np.array_equal(got, want), (mp, r)


def check_collectives(summary, pbytes: int) -> None:
    """DP: one flat all-reduce of [1.0, 1.25] x the parameter bytes, no
    gather; DP x TP: fewer bytes than the parameters, gathers below half."""
    dp = summary["layouts"]["1"]
    assert dp["param_bytes"] == pbytes
    c = dp["collectives"]
    assert c["all-gather"]["bytes"] == 0 and c["all-reduce"]["count"] == 1
    assert pbytes <= c["all-reduce"]["bytes"] <= 1.25 * pbytes
    assert c["all-reduce"] == dp["plan"]["all-reduce"]
    tp = summary["layouts"]["2"]
    assert tp["param_bytes"] == pbytes and 0 < tp["total_bytes"] < pbytes
    assert 0 < tp["collectives"]["all-gather"]["bytes"] < pbytes / 2


def test_dp_step_matches_jax(world):
    check_jax_step(world["out"], "mp1", world["jax"])


@pytest.mark.parametrize("layout", ["1", "2", "fast"])
def test_every_step_matches_the_plain_step(world, layout):
    check_replays(world["summary"], layout)


def test_epoch_rows_are_jax_multiprocess_staging(world):
    check_epoch_rows(world["out"], world["summary"], world["inputs"], WORLD, LAYOUTS, EPOCHS)


def test_step_collectives_keep_jax_invariants(world):
    check_collectives(world["summary"], world["param_bytes"])


def test_fast_preset_gathers_its_fused_decoder_layer(world):
    """The fast preset on 1 x 2: the fused decode+MSE kernel reads the
    decoder's output layer whole, so the layout gathers it (and cuts its
    gradient back to the slice) where the small model runs it
    row-parallel; the replay held every step (above)."""
    layouts = world["summary"]["layouts"]
    fast, small = layouts["fast"], layouts["2"]
    assert fast["tp_layout"]["decoder.out.weight"] == [1, "gather"], fast["tp_layout"]
    assert small["tp_layout"]["decoder.out.weight"] == [1, "row"], small["tp_layout"]
    assert fast["collectives"]["all-gather"]["bytes"] >= 4 * 192 * 512
    assert all(sum(c.values()) == 0 for steps in fast["launches"] for c in steps)  # the CPU


# ---------------------------------------------------------------------------
# the helpers against JAX's, and the refusals
# ---------------------------------------------------------------------------


def test_resolve_num_devices_matches_jax():
    assert jax.device_count() == 8
    mesh = Mesh(dp=8, ep=1, data_index=0, model_index=0)
    for devices in (None, "auto", "all", 1, 3, 8, 20):
        assert resolve_num_devices(devices, mesh) == jax_resolve_num_devices(devices)
    assert resolve_num_devices("all") == 1 and resolve_num_devices(4) == 4


@pytest.mark.parametrize("shape", [(12288, 512), (512, 12288), (256, 256), (192, 512),
                                   (16, 256), (3, 3, 256, 257), (65536,), (255, 257)])
def test_param_spec_matches_jax(shape):
    for model_size in (2, 4):
        spec, jspec = _param_spec(shape, model_size), tuple(jax_param_spec(shape, model_size))
        assert [a == MODEL_AXIS for a in spec] == [a == JAX_MODEL_AXIS for a in jspec]


def test_host_epoch_perm_and_usable_rows_match_jax():
    for seed, epoch, steps, bs, shard, n in ((0, 0, 3, 4, 13, 2), (42, 5, 2, 2, 9, 4)):
        np.testing.assert_array_equal(host_epoch_perm(seed, epoch, steps, bs, shard, n),
                                      jax_host_epoch_perm(seed, epoch, steps, bs, shard, n))
    mesh = Mesh(dp=4, ep=1, data_index=0, model_index=0)
    assert usable_local_rows(mesh, 13) == 13 and usable_local_rows(mesh, 13, 2) == 12


def test_data_module_strided_rows_match_jax(tmp_path):
    rows = np.random.default_rng(1).uniform(size=(11, 2, 3, 4, 4)).astype(np.float32)
    np.savez(tmp_path / "t.npz", sequences=rows)
    cfg = {"train_path": str(tmp_path / "t.npz"), "test_path": str(tmp_path / "t.npz"),
           "verify_cyclicity": False, "synthetic_fallback": False}
    tc = {"data": {"batch_size": 2}, "n_train_samples": 10, "n_val_samples": 4}
    for count in (1, 3):
        for index in range(count):
            port = CyclicDataModule(cfg, process_index=index, process_count=count)
            ref = JaxDataModule(cfg, process_index=index, process_count=count)
            port.setup(tc)
            ref.setup(tc)
            np.testing.assert_array_equal(port.train.data, ref.train.data)
            np.testing.assert_array_equal(port.val.data, ref.val.data)


def test_pipeline_keeps_the_ranks_rows_as_jax(monkeypatch):
    rows = np.random.default_rng(2).uniform(size=(9, 2, 3, 4, 4)).astype(np.float32)
    tc = {"data": {"batch_size": 4}}
    monkeypatch.setattr(pipelines, "data_shard", lambda cfg: (1, 2))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    port = pipelines._data_module_from_arrays(rows, rows[:3], tc)
    ref = jax_pipelines._data_module_from_arrays(rows, rows[:3], tc)
    np.testing.assert_array_equal(port.train.data, ref.train.data)
    np.testing.assert_array_equal(port.val.data, ref.val.data)
    assert port.batch_size == ref.batch_size and port.process_count == 2


def test_indivisible_global_batch_takes_the_per_step_loop():
    """A global batch the data axis does not divide: each rank walks its own
    rows at batch size // data axis (the remainder dropped), shuffled as
    the one-process loop shuffles; a batch below the axis raises."""
    rows = np.random.default_rng(3).uniform(size=(10, 2, 3, 4, 4)).astype(np.float32)
    data = CyclicDataModule(seed=4)
    data.train, data.batch_size = CyclicSequenceDataset(rows, verify_cyclicity=False), 5
    rank = SimpleNamespace(mesh=Mesh(dp=2, ep=1, data_index=1, model_index=0), data=data,
                           _to_device=torch.from_numpy)
    got = list(Trainer._train_batches(rank, 3))
    want = list(batch_iterator(rows, 2, shuffle=True, seed=4 + 3))
    assert len(got) == len(want) == 5
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    data.batch_size = 1
    with pytest.raises(ValueError, match="smaller than the data axis"):
        next(Trainer._train_batches(rank, 0))


def test_local_noise_takes_the_ranks_rows():
    mesh = Mesh(dp=2, ep=1, data_index=1, model_index=0)
    eps = torch.arange(8.0).reshape(8, 1)
    assert torch.equal(local_noise(mesh, eps, 4), eps[4:])
    assert torch.equal(local_noise(mesh, {"eps": eps[:4]}, 4)["eps"], eps[:4])
    with pytest.raises(ValueError, match="noise of 3 rows"):
        local_noise(mesh, eps[:3], 4)


def test_more_devices_outside_a_world_raise_naming_the_launcher(tmp_path):
    cfg = dp_verify.training_config(2, 1, 4, 8, 4)
    cfg["trainer"]["accelerator"] = "cpu"
    with pytest.raises(ValueError, match="--world"):
        Trainer(RlVAE(**dp_verify.SMALL), CyclicDataModule(), cfg, run_dir=tmp_path,
                device="cpu")
    cfg["trainer"].update({"devices": 1, "model_parallel": 2})
    with pytest.raises(ValueError, match="--world"):
        Trainer(RlVAE(**dp_verify.SMALL), CyclicDataModule(), cfg, run_dir=tmp_path,
                device="cpu")


def test_nccl_with_two_ranks_on_one_card_raises(tmp_path):
    with pytest.raises(ValueError, match="--backend gloo"):
        check_backend("nccl", torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError, match="--backend gloo"):
        dp_verify.main(["--world", str(torch.cuda.device_count() + 1), "--device", "cuda",
                        "--out", str(tmp_path)])
    assert not list(tmp_path.glob("rank*"))  # refused before any rank started
