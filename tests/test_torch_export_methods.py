"""The exported ``generate`` of every prior method JAX's ``export_model``
exports, and the exported ``reconstruct`` of the ``hmc`` posterior, on the
CPU at a small width (rlvae_tpu_torch/export.py).

- Each bundle's rows are the live ModelManager's rows bit for bit: at a
  bucket the batch fills, and at a padded bucket (3 rows, the last row and
  its draws repeated; generate's rows against the manager's at the bucket's
  batch size, reconstruct's against the manager run on the padded batch).
- The chains (``official``, ``hmc``, the ``hmc`` posterior) are one
  ``while_loop`` op each, with B4's registered op in the body once per
  evaluation of a step (16 for a prior chain's step, 10 for a posterior
  step), not 1601 or 200 times unrolled.
- JAX's ``export_model`` exports ``official`` and refuses ``adaptive``; the
  port refuses ``adaptive`` too, before it writes anything.

Torch runs on one thread: the suite runs six worker processes at once."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from rlvae_tpu_torch import ModelManager, PRESETS
from rlvae_tpu_torch.export import export_model, load_exported

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "data" / "pretrained"
SMALL = {
    **PRESETS["riemannian_flow_vae"],
    "input_dim": [3, 8, 8], "n_flows": 2, "flow_hidden_size": 32,
    "pretrained": {"metric_path": str(DATA / "metric_T0.7_scaled.npz")},
}
T = 4
SEEDS = np.asarray([7, 123, 7, 9], np.uint32)
NO_OPS = {"chol_bundle": 0, "iaf_chain_fwd": 0, "hmc_terms": 0, "metric_bundle": 0, "g_inv": 0,
          "basic_grad": 0, "energy_grad": 0}
# the registered ops each generate program holds (a loop body's once), as the
# eager generate launches them: B2 for the flows, and the prior's own
GRAPH_OPS = {
    "weighted_mixture": {"chol_bundle": 2, "iaf_chain_fwd": 1},
    "basic": {"basic_grad": 10, "iaf_chain_fwd": 1},
    "geodesic_exact": {"energy_grad": 1, "g_inv": 1, "iaf_chain_fwd": 1},
    "official": {"hmc_terms": 1 + 16, "iaf_chain_fwd": 1},
    "hmc": {"hmc_terms": 1 + 16, "iaf_chain_fwd": 1},
}
CHAINS = ("official", "hmc")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def manager():
    return ModelManager.from_config(SMALL, seed=0, device="cpu")


def _loops(path):
    """(top-level nodes, loop ops, B4 calls outside any loop) of a saved
    program."""
    ep = torch.export.load(path)
    loops = [n for n in ep.graph.nodes if n.target is torch.ops.higher_order.while_loop]
    top = sum(1 for n in ep.graph.nodes if n.op == "call_function"
              and getattr(n.target, "_schema", None) is not None
              and n.target._schema.name == "rlvae::hmc_terms")
    return len(ep.graph.nodes), len(loops), top


@pytest.mark.parametrize("method", list(GRAPH_OPS))
def test_generate_bundle_is_the_live_rows(manager, tmp_path, method):
    manifest = export_model(manager, tmp_path, ops=("generate",), buckets=(1, 4), n_obs=T,
                            generate_method=method)
    for b, spec in manifest["programs"]["generate"].items():
        assert spec["registered_ops"] == {**NO_OPS, **GRAPH_OPS[method]}, b
        assert spec["out_shape"] == [int(b), T, 3, 8, 8]
    loaded = load_exported(tmp_path, device="cpu")
    got = loaded.run("generate", SEEDS)
    want = manager.sample_random_batched_seeds(SEEDS, method, T)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], got[2])
    # padded: the last seed's draws repeated along each draw's row axis; the
    # manager's rows of one batch size do not depend on the other rows
    np.testing.assert_array_equal(loaded.run("generate", SEEDS[:3]), want[:3])
    if method in CHAINS:
        # the chain is one loop op: B4 once before it (the start's terms) and
        # 16 times in its body, not 1601 times in the graph (the bucket-1
        # program's count is the manifest's, above)
        nodes, loops, top = _loops(tmp_path / "generate_b4.pt2")
        assert (loops, top) == (1, 1) and nodes < 200, (nodes, loops, top)
        spec = manifest["noise"]["generate"]
        assert [(s["name"], s.get("row_axis", 0)) for s in spec][1:] == [("gammas", 1),
                                                                         ("unifs", 1)]


def test_hmc_posterior_reconstruct_bundle_is_the_live_rows(tmp_path):
    cfg = copy.deepcopy(PRESETS["hybrid_rlvae"])
    cfg.update({"input_dim": [3, 8, 8], "n_flows": 2, "flow_hidden_size": 32,
                "pretrained": {"metric_path": str(DATA / "metric.npz")}})
    cfg["sampling"]["method"] = "hmc"
    mgr = ModelManager.from_config(cfg, seed=0, device="cpu")
    manifest = export_model(mgr, tmp_path, ops=("reconstruct",), buckets=(1, 4), n_obs=T)
    assert [(s["name"], s["shape"], s.get("row_axis", 0))
            for s in manifest["noise"]["reconstruct"]] == [("eps", [16], 0),
                                                           ("gammas", [20, 16], 1)]
    for b, spec in manifest["programs"]["reconstruct"].items():
        # 20 steps x 5 leapfrogs x 2 evaluations: ten B4 calls in the loop body
        assert spec["registered_ops"] == {**NO_OPS, "hmc_terms": 10, "iaf_chain_fwd": 1}, b
        assert _loops(tmp_path / spec["file"])[1:] == (1, 0)
    loaded = load_exported(tmp_path, device="cpu")
    x = np.random.default_rng(1).uniform(size=(4, T, 3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(loaded.run("reconstruct", x), mgr.reconstruct(x, seed=0))
    # padded: 3 rows' draws from seed 0, the last row's repeated (gammas on axis 1)
    noise = mgr.model.draw_posterior_noise(3, torch.Generator().manual_seed(0))
    noise = {"eps": torch.cat([noise["eps"], noise["eps"][-1:]]),
             "gammas": torch.cat([noise["gammas"], noise["gammas"][:, -1:]], dim=1)}
    want = mgr.reconstruct_rows(np.concatenate([x[:3], x[2:3]]), noise=noise)[:3].numpy()
    np.testing.assert_array_equal(loaded.run("reconstruct", x[:3]), want)


def test_adaptive_is_refused_as_jax_refuses_it(manager, tmp_path):
    """JAX's export_model exports the official chain and refuses the
    self-tuning sampler (it passes no plan, and the sampler's host-side
    n_lf decision meets a tracer); the port refuses it before writing."""
    import jax

    from rlvae_tpu.export import export_model as jax_export
    from rlvae_tpu.inference import ModelManager as JaxManager

    jm = JaxManager.from_config(SMALL, seed=0)
    m = jax_export(jm, tmp_path / "jax_official", ops=("generate",), buckets=(1,), n_obs=T,
                   generate_method="official")
    assert list(m["programs"]["generate"]) == ["1"]
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax_export(jm, tmp_path / "jax_adaptive", ops=("generate",), buckets=(1,), n_obs=T,
                   generate_method="adaptive")
    with pytest.raises(ValueError, match="adaptive.*not exportable.*JAX"):
        export_model(manager, tmp_path / "port", ops=("generate",), generate_method="adaptive")
    assert not (tmp_path / "port").exists()  # refused before anything is written
    with pytest.raises(ValueError, match="Unknown prior sampling method"):
        export_model(manager, tmp_path / "port", ops=("generate",), generate_method="nope")
