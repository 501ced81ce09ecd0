"""Ahead-of-time export of the port (rlvae_tpu_torch/export.py) and its
bundle server, on the CPU at a small width.

The cases mirror tests/test_export.py.  Parity:

- with the port's live ModelManager: a bundle program runs the same ops as
  the eager forward on the same inputs and draws, so at a batch that fills
  its bucket every row is held bit for bit (reconstruct, encode, decode,
  generate), and a padded bucket's rows bit for bit against the manager
  run on the same padded batch and draws (the CPU's plain versions round a
  row by the batch it sits in: ROADMAP C3);
- with JAX's bundle: the encode and decode programs of a model whose
  weights rlvae_tpu_torch.convert carried from JAX's, at 1e-5 (fp32 nets);
- int8: the dequantized weights equal JAX's dequantized weights, carried
  across the same way, bit for bit (the same numpy quantization on the
  transposed layout, the same fp32 product in-program).

The registered ops are counted in each exported graph: reconstruct holds
two chol-bundles (the posterior and the KL the forward computes, as its
eager run launches) and one IAF chain, generate one G^{-1} and one IAF
chain, encode and decode none."""

import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from rlvae_tpu_torch import BatchingEngine, ModelManager, PRESETS, ServeConfig
from rlvae_tpu_torch.export import dequantize, draw_noise, export_model, load_exported

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "data" / "pretrained"
SMALL = {
    **PRESETS["riemannian_flow_vae"],
    "input_dim": [3, 8, 8], "n_flows": 2, "flow_hidden_size": 32,
    "pretrained": {"metric_path": str(DATA / "metric_T0.7_scaled.npz")},
}
# tests/test_export.py's TINY with fp32 nets, built on both sides
TINY = {
    "name": "vanilla_vae", "input_dim": [3, 8, 8], "latent_dim": 4, "n_flows": 2,
    "flow_hidden_size": 16,
    "encoder": {"architecture": "mlp", "hidden_dims": [16], "dtype": "float32"},
    "decoder": {"architecture": "mlp", "hidden_dims": [16], "dtype": "float32"},
}
T = 4
NO_OPS = {"chol_bundle": 0, "iaf_chain_fwd": 0, "hmc_terms": 0, "metric_bundle": 0, "g_inv": 0,
          "basic_grad": 0, "energy_grad": 0}


@pytest.fixture(scope="module")
def manager():
    return ModelManager.from_config(SMALL, seed=0, device="cpu")


@pytest.fixture(scope="module")
def bundle(manager, tmp_path_factory):
    out = tmp_path_factory.mktemp("bundle")
    manifest = export_model(manager, out, buckets=(1, 4), n_obs=T)
    return out, manifest, load_exported(out, device="cpu")


@pytest.fixture(scope="module")
def serving_bundle(manager, tmp_path_factory):
    """decode and generate at buckets 1 and 4: what the HTTP tests serve."""
    out = tmp_path_factory.mktemp("serving")
    export_model(manager, out, ops=("decode", "generate"), buckets=(1, 4), n_obs=T)
    return out


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX manager, port manager) of TINY on the same weights."""
    import jax

    from rlvae_tpu.inference import ModelManager as JaxManager
    from rlvae_tpu_torch.convert import from_jax_variables
    from rlvae_tpu_torch.models import create_model

    jm = JaxManager.from_config(TINY, seed=0)
    pm = create_model(TINY)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jm.variables)))
    return jm, ModelManager(pm, "cpu")


def _seqs(n, seed=1):
    return np.random.default_rng(seed).uniform(size=(n, T, 3, 8, 8)).astype(np.float32)


def _padded_noise(manager, n, b):
    """reconstruct's draws for n rows from seed 0, padded to b as the bundle pads."""
    noise = manager.model.draw_posterior_noise(n, torch.Generator().manual_seed(0))
    return {k: torch.cat([v, v[-1:].expand(b - n, *v.shape[1:])]) for k, v in noise.items()}


def test_decode_roundtrip_quick(manager, tmp_path):
    export_model(manager, tmp_path, ops=("decode",), buckets=(4,), n_obs=T)
    loaded = load_exported(tmp_path, device="cpu")
    z = np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32)
    np.testing.assert_array_equal(loaded.run("decode", z), manager.decode(z))
    # a padded bucket slices back; decode treats rows alone
    np.testing.assert_allclose(loaded.run("decode", z[:3]), manager.decode(z[:3]),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="exceeds"):
        loaded.run("decode", np.zeros((5, 16), np.float32))
    with pytest.raises(KeyError):
        loaded.run("nope", z)


def test_full_bundle_parity_and_engine(manager, bundle):
    out, manifest, loaded = bundle
    assert set(manifest["programs"]) == {"reconstruct", "encode", "decode", "generate"}
    assert json.loads((out / "manifest.json").read_text()) == json.loads(json.dumps(manifest))
    assert manifest["torch_version"] == torch.__version__
    assert [s["name"] for s in manifest["noise"]["reconstruct"]] == ["eps"]
    assert [s["name"] for s in manifest["noise"]["generate"]] == ["i1", "i2", "t", "eps"]
    for b in ("1", "4"):
        ops = {op: manifest["programs"][op][b]["registered_ops"] for op in manifest["programs"]}
        assert ops["reconstruct"] == {**NO_OPS, "chol_bundle": 2, "iaf_chain_fwd": 1}
        assert ops["generate"] == {**NO_OPS, "g_inv": 1, "iaf_chain_fwd": 1}
        assert ops["encode"] == ops["decode"] == NO_OPS
    assert manifest["programs"]["generate"]["4"]["out_shape"] == [4, T, 3, 8, 8]

    x = _seqs(4)
    # full buckets: the eager forward's ops on the same draws, bit for bit
    np.testing.assert_array_equal(loaded.run("reconstruct", x), manager.reconstruct(x, seed=0))
    np.testing.assert_array_equal(loaded.run("reconstruct", x[:1]),
                                  manager.reconstruct(x[:1], seed=0))
    # a padded bucket: 3 rows' draws, the last row repeated
    want = manager.reconstruct_rows(np.concatenate([x[:3], x[2:3]]),
                                    noise=_padded_noise(manager, 3, 4))[:3].numpy()
    np.testing.assert_array_equal(loaded.run("reconstruct", x[:3]), want)
    np.testing.assert_array_equal(loaded.run("encode", x[:, 0]), manager.encode(x[:, 0]).embedding)
    np.testing.assert_allclose(loaded.run("encode", x[:3, 0]), manager.encode(x[:3, 0]).embedding,
                               rtol=0, atol=1e-3)  # bf16 encoder, another batch (compare_forward)

    seeds = np.asarray([7, 123, 7, 9], np.uint32)
    gen = loaded.run("generate", seeds)
    np.testing.assert_array_equal(gen, manager.sample_random_batched_seeds(seeds, n_obs=T))
    np.testing.assert_array_equal(gen[0], gen[2])
    # padded: the last seed's draws repeated, as the engine pads its seeds
    np.testing.assert_array_equal(
        loaded.run("generate", seeds[:3]),
        manager.sample_random_batched_seeds(np.r_[seeds[:3], seeds[2]], n_obs=T)[:3])

    eng = BatchingEngine(loaded.as_ops(), ServeConfig(buckets=(1, 4), max_wait_ms=50.0))
    try:
        zs = np.random.default_rng(2).normal(size=(4, 16)).astype(np.float32)
        futs = [eng.submit("decode", z) for z in zs]
        outs = np.stack([f.result(timeout=60) for f in futs])
        np.testing.assert_allclose(outs, manager.decode(zs), rtol=0, atol=1e-5)
    finally:
        eng.stop()


def test_noise_recipe_is_the_models_draw(manager, bundle, tmp_path):
    _, manifest, _ = bundle
    gen = torch.Generator().manual_seed(5)
    drawn = manager.model.draw_generation_noise(1, "geodesic", torch.Generator().manual_seed(5))
    mine = draw_noise(manifest["noise"]["generate"], 1, gen, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(mine, drawn.values()))
    with pytest.raises(ValueError, match="not exportable"):
        export_model(manager, tmp_path, ops=("generate",), generate_method="adaptive")
    assert not any(tmp_path.iterdir())  # refused before anything is written


def test_weight_swap_without_reexport(manager, tmp_path):
    export_model(manager, tmp_path, ops=("decode",), buckets=(2,), n_obs=T)
    loaded = load_exported(tmp_path, device="cpu")
    other = ModelManager.from_config(SMALL, seed=1, device="cpu")
    z = np.random.default_rng(2).normal(size=(2, 16)).astype(np.float32)
    before = loaded.run("decode", z)
    loaded.set_weights(other.model)
    after = loaded.run("decode", z)
    np.testing.assert_allclose(after, other.decode(z), rtol=0, atol=1e-5)
    assert not np.allclose(before, after)
    with pytest.raises(ValueError, match="leaves"):
        loaded.set_weights({})
    with pytest.raises(ValueError, match="dtype"):
        loaded.set_weights({k: v.double() for k, v in other.model.state_dict().items()})


def test_platforms(manager, tmp_path):
    """One saved program serves every listed device type: the load moves the
    devices its graph names.  The CPU shows this by moving a CPU-traced
    program to the meta device, where the registered ops' fake versions
    run, and by refusing a device type the bundle does not list."""
    m = export_model(manager, tmp_path, ops=("decode",), buckets=(2,), n_obs=T,
                     platforms=("cpu", "cuda"))
    assert m["platforms"] == ["cpu", "cuda"] and m["traced_on"] == "cpu"
    loaded = load_exported(tmp_path, device="cpu")
    z = np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32)
    np.testing.assert_array_equal(loaded.run("decode", z), manager.decode(z))
    with pytest.raises(ValueError, match="exported for"):
        load_exported(tmp_path, device="meta")
    with pytest.raises(ValueError, match="unknown platforms"):
        export_model(manager, tmp_path / "x", ops=("decode",), platforms=("tpu",))

    from torch.export.passes import move_to_device_pass

    ep = move_to_device_pass(torch.export.load(tmp_path / "decode_b2.pt2"), "meta")
    leaves = tuple(w.to("meta") for w in loaded._weights)
    y = ep.module()(leaves, torch.zeros((2, 16), device="meta"))
    assert y.device.type == "meta" and tuple(y.shape) == (2, 3, 8, 8)


def test_format_version_enforced(manager, tmp_path):
    export_model(manager, tmp_path, ops=("decode",), buckets=(1,), n_obs=T)
    m = json.loads((tmp_path / "manifest.json").read_text())
    m["format_version"] = 999
    (tmp_path / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="unsupported export format"):
        load_exported(tmp_path, device="cpu")


def test_encode_decode_bundles_match_jax(tiny_pair, tmp_path):
    """The port's bundle against JAX's bundle of the same weights (fp32 nets)."""
    from rlvae_tpu.export import export_model as jax_export
    from rlvae_tpu.export import load_exported as jax_load

    jm, pm = tiny_pair
    jax_export(jm, tmp_path / "jax", ops=("encode", "decode"), buckets=(4,), n_obs=T)
    export_model(pm, tmp_path / "port", ops=("encode", "decode"), buckets=(4,), n_obs=T)
    jb, pb = jax_load(tmp_path / "jax"), load_exported(tmp_path / "port", device="cpu")
    rng = np.random.default_rng(3)
    frames = rng.uniform(size=(3, 3, 8, 8)).astype(np.float32)
    z = rng.normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_allclose(pb.run("encode", frames), jb.run("encode", frames),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(pb.run("decode", z), jb.run("decode", z), rtol=0, atol=1e-5)


def test_int8_weight_only_quantized_export(tiny_pair, tmp_path):
    """int8 stores the large 2-D weights as int8 + per-output scales, its
    dequantized weights are JAX's bit for bit, it stays within the JAX
    test's quality gate, and a weight swap re-quantizes."""
    import jax

    from rlvae_tpu.export import _make_unpack, _pack_leaves, _quant_plan
    from rlvae_tpu_torch.convert import from_jax_variables

    jm, pm = tiny_pair
    export_model(pm, tmp_path / "f32", ops=("decode",), buckets=(4,), n_obs=T)
    m = export_model(pm, tmp_path / "int8", ops=("decode",), buckets=(4,), n_obs=T,
                     quantize="int8")
    assert m["quantization"]["mode"] == "int8"
    assert len(m["quantization"]["leaf_indices"]) >= 2  # the Dense kernels
    assert (tmp_path / "int8" / "weights.npz").stat().st_size < \
        (tmp_path / "f32" / "weights.npz").stat().st_size

    # the port's dequantized state against JAX's, carried across
    with np.load(tmp_path / "int8" / "weights.npz") as zf:
        packed = [torch.from_numpy(zf[str(i)]) for i in range(m["n_weight_leaves"])]
    dtypes = [getattr(torch, d.split(".")[1]) for d in m["leaf_dtypes"]]
    port = dict(zip(m["leaf_names"], dequantize(packed, m["quantization"]["leaf_indices"],
                                                dtypes)))
    leaves, treedef = jax.tree_util.tree_flatten(jm.variables)
    leaves = [np.asarray(x) for x in leaves]
    plan = _quant_plan(leaves, "int8")
    assert len(plan) == len(m["quantization"]["leaf_indices"])
    unpacked = _make_unpack(plan, [x.dtype for x in leaves])(_pack_leaves(leaves, plan))
    jax_deq = from_jax_variables(jax.tree_util.tree_unflatten(
        treedef, [np.asarray(x) for x in unpacked]))
    for name, want in jax_deq.items():
        np.testing.assert_array_equal(port[name].numpy(), want.numpy(), err_msg=name)

    loaded = load_exported(tmp_path / "int8", device="cpu")
    z = np.random.default_rng(3).normal(size=(4, 4)).astype(np.float32)
    got, ref = loaded.run("decode", z), pm.decode(z)
    assert np.max(np.abs(got - ref)) < 0.05 and np.mean(np.abs(got - ref)) < 0.01
    loaded.set_weights(pm.model)
    np.testing.assert_array_equal(loaded.run("decode", z), got)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        export_model(pm, tmp_path / "bad", ops=("decode",), buckets=(4,), n_obs=T,
                     quantize="int4")


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def test_bundle_server_serves_over_http(manager, serving_bundle):
    from rlvae_tpu_torch.bundle_server import serve_bundle

    httpd, engine = serve_bundle(serving_bundle, port=0, max_wait_ms=20.0, device="cpu")
    port = httpd.server_address[1]
    try:
        ops = _get(port, "/ops")
        assert ops["ops"] == {"decode": [1, 4], "generate": [1, 4]}
        assert ops["manifest"]["latent_dim"] == 16
        z = np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32)
        got = np.asarray(_post(port, "/v1/decode", {"items": z.tolist()})["outputs"], np.float32)
        np.testing.assert_allclose(got, manager.decode(z), rtol=0, atol=1e-5)
        gen = np.asarray(_post(port, "/v1/generate", {"items": [7]})["outputs"], np.float32)
        np.testing.assert_array_equal(gen, manager.sample_random_batched_seeds([7], n_obs=T))
        assert _get(port, "/stats")["requests"] == 4
        with pytest.raises(urllib.error.HTTPError):
            _post(port, "/v1/nope", {"items": [[0.0]]})
        with pytest.raises(urllib.error.HTTPError):
            _post(port, "/v1/decode", {"items": []})
    finally:
        httpd.shutdown()
        engine.stop()


_NO_MODEL_CODE = """
import json, sys, urllib.request
from rlvae_tpu_torch.bundle_server import serve_bundle
outs = []
for bundle in sys.argv[1:]:
    httpd, engine = serve_bundle(bundle, port=0, device="cpu")
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/generate",
            data=json.dumps({"items": [7]}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            outs.append(json.loads(r.read())["outputs"])
    finally:
        httpd.shutdown()
        engine.stop()
loaded = sorted(m for m in sys.modules if m.startswith("rlvae_tpu_torch.models"))
print([len(o) for o in outs], loaded)
sys.exit(0 if [len(o) for o in outs] == [1] * len(outs) and not loaded else 1)
"""


@pytest.fixture(scope="module")
def official_bundle(manager, tmp_path_factory):
    """generate by the official chain at bucket 1: the chain's draws (the
    start's centroid index, step-major momenta and uniforms) in the recipe."""
    out = tmp_path_factory.mktemp("official")
    export_model(manager, out, ops=("generate",), buckets=(1,), n_obs=T,
                 generate_method="official")
    return out


def test_bundle_server_imports_no_model_code(serving_bundle, official_bundle):
    """A host with the bundle, torch and the port's ops serves a request
    (a generate: G^{-1} and the IAF chain; and the official chain's, whose
    draws gather their start in the program) without importing a model
    class."""
    proc = subprocess.run([sys.executable, "-c", _NO_MODEL_CODE, str(serving_bundle),
                           str(official_bundle)], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
