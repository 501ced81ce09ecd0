"""The port's centroid-sharded (EP) metric path against the JAX package on
the CPU: the HMC partials (B8's plain version), the padded bank, the
sharded HMC terms, G^{-1}, its Cholesky factor and the prior chain, in one
process (the 1 x 1 mesh) and across 2 and 4 gloo processes
(``rlvae_tpu_torch.parallel.ep_verify``) against JAX meshes of the same
shape.  Seeded numpy banks go through ``CentroidMetric.create`` on both
sides; the chains run on JAX's draws.

Tolerances, each with its reason:
- partials: gi_part within 1e-5 and v within 1e-4 of max(1, |JAX|)
  elementwise (fp32 sums over K in another order; v is a contraction of
  weighted differences, 16 terms per centroid).
- terms: log pi atol 1e-5 and grad atol 1e-4, JAX's own tolerances for its
  sharded terms against the dense ones; G^{-1} and L within 1e-5 of
  max(1, |JAX|) (gloo's sum and XLA's psum add in other orders).
- chains (6 MCMC x 3 leapfrog steps at eps 0.05): z atol 1e-4 and the accept
  rate 1e-6, as ``tests/test_metric_parallel.py`` holds JAX's sharded chain
  to its dense one.
- padding: exact (far centroids add w = 0 times a zero matrix).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.geometry import metric as jgm
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.ops.metric_kernels import hmc_partials_pallas
from rlvae_tpu.parallel import metric_parallel as jmp
from rlvae_tpu.parallel.mesh import create_mesh as jax_create_mesh
from rlvae_tpu.samplers import hmc as jhmc
from rlvae_tpu_torch.geometry import metric as tgm
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.ops.metric_kernels import hmc_partials, hmc_partials_ref
from rlvae_tpu_torch.parallel import ep_verify
from rlvae_tpu_torch.parallel import metric_parallel as tmp
from rlvae_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, create_mesh
from rlvae_tpu_torch.samplers import hmc as thmc

DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
LP_ATOL, GRAD_ATOL = 1e-5, 1e-4
GI_REL, V_REL = 1e-5, 1e-4
CHAIN = dict(mcmc_steps=6, n_lf=3, eps_lf=0.05)


def _spd_bank(k, seed, temperature=0.8):
    """A seeded K-centroid bank at D=16: SPD matrices a a^T + 0.5 I."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, 16)).astype(np.float32)
    a = rng.normal(size=(k, 16, 16)).astype(np.float32) * 0.3
    m = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(16, dtype=np.float32)
    return c, m.astype(np.float32), temperature, 0.01


def _pretrained_bank():
    """The default model's K=50 metric, its temperature overridden to 3.0."""
    with np.load(DATA / "metric_T0.7_scaled.npz") as f:
        return (f["centroids"].astype(np.float32), f["M_matrices"].astype(np.float32), 3.0,
                float(f["regularization"]))


BANKS = {"pretrained50": _pretrained_bank, "k37": lambda: _spd_bank(37, 3),
         "k2000": lambda: _spd_bank(2000, 4, temperature=2.0)}


def _pair(name):
    c, m, t, lbd = BANKS[name]()
    return (JaxMetric.create(c, m, temperature=t, regularization=lbd),
            CentroidMetric.create(c, m, temperature=t, regularization=lbd))


def _latents(centroids, b, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    c = np.asarray(centroids)
    return (c[rng.integers(0, c.shape[0], size=b)]
            + scale * rng.normal(size=(b, c.shape[1]))).astype(np.float32)


def _within(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= rel * np.maximum(1.0, np.abs(want))), float(err.max())


def _jax_draws(jm, init, n, seed):
    """The draws of JAX's (dense and sharded) sampler for PRNGKey(seed)."""
    k_init, k_chain = jax.random.split(jax.random.PRNGKey(seed))
    if init == "centroids":
        z0 = np.asarray(jm.centroids)[np.asarray(
            jax.random.randint(k_init, (n,), 0, jm.n_centroids))]
    else:
        z0 = np.asarray(jax.random.normal(k_init, (n, 16)))
    gammas, unifs = jhmc.draw_chain_noise(k_chain, CHAIN["mcmc_steps"], n, 16)
    return z0.astype(np.float32), np.array(gammas), np.array(unifs)


def _jax_sharded(fn, jmesh, jbank, z, **kw):
    """JAX's sharded ``fn`` under ``jit``, as its callers run it (its eager
    ``shard_map`` dispatches op by op and takes minutes at D=16)."""
    return jax.jit(lambda bank, zz: fn(jmesh, bank, zz, **kw))(jbank, jnp.asarray(z))


def _jax_sharded_all(jmesh, jbank, z):
    """JAX's sharded (log pi, grad), G^{-1} and L (jitter 1e-6) in one
    jitted program, compiled once."""
    def run(bank, zz):
        return (*jmp.hmc_terms_sharded(jmesh, bank, zz), jmp.g_inv_sharded(jmesh, bank, zz),
                jmp.chol_g_inv_sharded(jmesh, bank, zz, jitter=1e-6))
    return jax.jit(run)(jbank, jnp.asarray(z))


@functools.lru_cache(maxsize=None)
def _jax_dense_chain(bank, init, n, seed):
    """JAX's dense ``sample_prior_hmc`` on bank ``bank``: (z, accept rate,
    log pi), computed once per file for each of its arguments."""
    jm = _pair(bank)[0]
    cfg = jhmc.HMCConfig(**CHAIN, init=init, backend="xla")
    z, diag = jhmc.sample_prior_hmc(jm, jax.random.PRNGKey(seed), n, cfg,
                                    return_diagnostics=True)
    return np.asarray(z), float(diag["accept_rate"]), np.asarray(diag["log_pi"])


# ---------------------------------------------------------------------------
# the partials (B8's plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bank,b", [("pretrained50", 16), ("pretrained50", 37), ("k37", 16),
                                    ("k37", 37), ("k2000", 16)])
def test_hmc_partials_match_jax_kernel_and_xla(bank, b):
    """The plain partials (the wrapper on CPU tensors) against JAX's Pallas
    kernel in interpret mode (K=2000 through its K-chunked body, forced by
    tb=512) and JAX's XLA partials."""
    jm, tm = _pair(bank)
    z = _latents(jm.centroids, b, seed=b)
    tb = 512 if jm.n_centroids == 2000 else None
    want_k = hmc_partials_pallas(jm, jnp.asarray(z), tb=tb, interpret=True)
    want_x = jmp._partial_terms(jm.centroids, jm.matrices, jm.temperature, jm.regularization,
                                jnp.asarray(z), backend="xla")
    inv_t2 = 1.0 / tm.temperature ** 2
    got = hmc_partials(torch.from_numpy(z), tm.centroids, tm.matrices, inv_t2)
    plain = hmc_partials_ref(torch.from_numpy(z), tm.centroids, tm.matrices, inv_t2)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    for want in (want_k, want_x):
        _within(got[0].numpy(), want[0], GI_REL)
        _within(got[1].numpy(), want[1], V_REL)


def test_hmc_partials_reject_other_devices():
    z = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hmc_partials(z, torch.zeros((3, 16), device="meta"),
                     torch.zeros((3, 16, 16), device="meta"), 1.0)


# ---------------------------------------------------------------------------
# padding and sharding of the bank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_pad_metric_is_exact_and_matches_jax(shards):
    jm, tm = _pair("k37")
    padded, jpadded = tmp.pad_metric(tm, shards), jmp.pad_metric(jm, shards)
    assert padded.n_centroids == jpadded.n_centroids == -(-37 // shards) * shards
    np.testing.assert_array_equal(padded.centroids.numpy(), np.asarray(jpadded.centroids))
    np.testing.assert_array_equal(padded.matrices.numpy(), np.asarray(jpadded.matrices))
    z = torch.from_numpy(_latents(jm.centroids, 16, seed=shards))
    np.testing.assert_allclose(tgm.g_inv(padded, z).numpy(), tgm.g_inv(tm, z).numpy(),
                               rtol=0, atol=0)
    assert tmp.pad_metric(padded, shards) is padded


def test_shard_metric_cuts_contiguous_slices_of_the_padded_bank():
    _, tm = _pair("k37")
    padded = tmp.pad_metric(tm, 4)
    shards = [tmp.shard_metric(Mesh(dp=2, ep=4, data_index=1, model_index=i), tm)
              for i in range(4)]
    assert all(s.n_centroids == 10 for s in shards)
    assert torch.equal(torch.cat([s.centroids for s in shards]), padded.centroids)
    assert torch.equal(torch.cat([s.matrices for s in shards]), padded.matrices)
    assert tmp.shard_metric(create_mesh(), tm).n_centroids == 37


@pytest.mark.parametrize("shards", [2, 4])
def test_shard_views_start_where_the_kernels_bulk_copies_need(shards):
    """A shard is a view into the padded bank at a whole number of
    centroids (64-byte rows of c, 1 KB of M): its start keeps the bank's
    64-byte alignment, so the metric kernels' 16-byte check passes (their
    bulk copies need it; on the card ``g_inv`` launches on these views)."""
    from rlvae_tpu_torch.ops.metric_kernels import _check_bank_alignment

    _, tm = _pair("k37")
    for i in range(shards):
        s = tmp.shard_metric(Mesh(dp=1, ep=shards, data_index=0, model_index=i), tm)
        assert s.centroids.storage_offset() * 4 % 64 == 0, i
        assert s.matrices.storage_offset() * 4 % 64 == 0, i
        assert s.centroids.data_ptr() % 16 == 0 and s.matrices.data_ptr() % 16 == 0, i
        _check_bank_alignment("g_inv", s.centroids, s.matrices)


# ---------------------------------------------------------------------------
# one process: the 1 x 1 mesh
# ---------------------------------------------------------------------------


def test_trivial_mesh_without_a_process_group():
    mesh = create_mesh()
    assert (mesh.dp, mesh.ep, mesh.data_index, mesh.model_index) == (1, 1, 0, 0)
    assert mesh.group(MODEL_AXIS) is None and mesh.group(DATA_AXIS) is None
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    with pytest.raises(ValueError, match="model_parallel"):
        create_mesh(model_parallel=2)


@pytest.mark.parametrize("bank", ["pretrained50", "k37"])
def test_hmc_terms_sharded_matches_jax_sharded_and_dense(bank):
    """The port's terms on the 1 x 1 mesh against JAX's sharded terms on a
    4 x 2 mesh and its dense terms, with exactly one model-group all-reduce
    per evaluation."""
    jm, tm = _pair(bank)
    z = _latents(jm.centroids, 16, seed=7)
    jmesh = jax_create_mesh(model_parallel=2)
    j_lp, j_grad = _jax_sharded(jmp.hmc_terms_sharded, jmesh, jmp.shard_metric(jmesh, jm), z)
    d_lp, d_grad = jgm.log_sqrt_det_g_inv(jm, jnp.asarray(z)), jgm.grad_log_sqrt_det_g_inv(
        jm, jnp.asarray(z))
    mesh = create_mesh()
    shard = tmp.shard_metric(mesh, tm)
    before = dict(tmp.all_reduce_sum.calls)
    lp, grad = tmp.hmc_terms_sharded(mesh, shard, torch.from_numpy(z))
    assert tmp.all_reduce_sum.calls[MODEL_AXIS] == before[MODEL_AXIS] + 1
    assert tmp.all_reduce_sum.calls[DATA_AXIS] == before[DATA_AXIS]
    for want_lp, want_grad in ((j_lp, j_grad), (d_lp, d_grad)):
        np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=0, atol=LP_ATOL)
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=0,
                                   atol=GRAD_ATOL)


def test_g_inv_and_chol_sharded_match_jax():
    jm, tm = _pair("k37")
    z = _latents(jm.centroids, 16, seed=8)
    jmesh = jax_create_mesh(model_parallel=4)
    jbank = jmp.shard_metric(jmesh, jm)
    mesh = create_mesh()
    shard = tmp.shard_metric(mesh, tm)
    _within(tmp.g_inv_sharded(mesh, shard, torch.from_numpy(z)).numpy(),
            _jax_sharded(jmp.g_inv_sharded, jmesh, jbank, z), GI_REL)
    _within(tmp.chol_g_inv_sharded(mesh, shard, torch.from_numpy(z), jitter=1e-6).numpy(),
            _jax_sharded(jmp.chol_g_inv_sharded, jmesh, jbank, z, jitter=1e-6), GI_REL)


def test_g_inv_sharded_goes_through_the_g_inv_wrapper(monkeypatch):
    """The shard's sum is one ``g_inv`` call (the G^{-1} kernel on the card,
    counted through the module attribute that ``GInv`` calls), and the
    result is still JAX's ``g_inv_sharded``."""
    from rlvae_tpu_torch.ops import metric_kernels as mk

    calls = []
    real = mk.g_inv

    def counting(z, *args):
        calls.append(tuple(z.shape))
        return real(z, *args)

    monkeypatch.setattr(mk, "g_inv", counting)
    jm, tm = _pair("pretrained50")
    z = _latents(jm.centroids, 8, seed=9)
    jmesh = jax_create_mesh(model_parallel=1)
    mesh = create_mesh()
    shard = tmp.shard_metric(mesh, tm)
    got = tmp.g_inv_sharded(mesh, shard, torch.from_numpy(z))
    assert calls == [(8, 16)]
    _within(got.numpy(), _jax_sharded(jmp.g_inv_sharded, jmesh, jmp.shard_metric(jmesh, jm), z),
            GI_REL)
    tmp.chol_g_inv_sharded(mesh, shard, torch.from_numpy(z))
    assert calls == [(8, 16)] * 2


def test_g_inv_sharded_any_dim_on_the_cpu():
    """Off the card the plain version takes any D (the kernel takes D=16 and
    its wrapper raises for another on the card): a D=8 bank split into 2
    padded shards, summed in shard order, equals the dense G^{-1}."""
    rng = np.random.default_rng(11)
    c = rng.normal(size=(9, 8)).astype(np.float32)
    a = rng.normal(size=(9, 8, 8)).astype(np.float32) * 0.3
    m = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(8, dtype=np.float32)).astype(np.float32)
    tm = CentroidMetric.create(c, m, temperature=0.9, regularization=0.01)
    z = torch.from_numpy(_latents(c, 5, seed=12))
    parts = [tmp.g_inv_sharded(create_mesh(), tmp.shard_metric(
        Mesh(dp=1, ep=2, data_index=0, model_index=i), tm), z) for i in range(2)]
    eye = 0.01 * torch.eye(8)
    got = (parts[0] - eye) + (parts[1] - eye) + eye
    want = tgm.g_inv(tm, z)
    assert got.shape == (5, 8, 8)
    _within(got.numpy(), want.numpy(), GI_REL)


@pytest.mark.parametrize("init", ["centroids", "randn"])
def test_sharded_chain_on_one_process_matches_jax_dense(init):
    """The sharded chain on the 1 x 1 mesh, on JAX's draws, against JAX's
    dense ``sample_prior_hmc``; one model-group all-reduce per evaluation
    and one data-group all-reduce per MCMC step."""
    jm, tm = _pair("k37")
    n, seed = 8, 7 if init == "centroids" else 11
    want_z, want_rate, want_lp = _jax_dense_chain("k37", init, n, seed)
    z0, gammas, unifs = _jax_draws(jm, init, n, seed)
    before = dict(tmp.all_reduce_sum.calls)
    z, diag = tmp.sample_prior_hmc_sharded(
        create_mesh(), tm, n, thmc.HMCConfig(**CHAIN, init=init), z0=torch.from_numpy(z0),
        gammas=torch.from_numpy(gammas), unifs=torch.from_numpy(unifs),
        return_diagnostics=True)
    calls = {a: tmp.all_reduce_sum.calls[a] - before[a] for a in before}
    assert calls == {MODEL_AXIS: 1 + CHAIN["mcmc_steps"] * (CHAIN["n_lf"] + 1),
                     DATA_AXIS: CHAIN["mcmc_steps"]}
    np.testing.assert_allclose(z.numpy(), want_z, rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(diag["accept_rate"]), want_rate, rtol=0, atol=1e-6)
    np.testing.assert_allclose(diag["log_pi"].numpy(), want_lp, rtol=0, atol=1e-4)


def test_sharded_chain_draws_its_own_noise_like_the_dense_sampler():
    """Without given draws the chain draws them as ``draw_hmc_noise`` does,
    from the generator: the same chain as the dense sampler's."""
    _, tm = _pair("k37")
    cfg = thmc.HMCConfig(**CHAIN)
    z = tmp.sample_prior_hmc_sharded(create_mesh(), tm, 4, cfg,
                                     generator=torch.Generator().manual_seed(3))
    want = thmc.sample_prior_hmc(tm, 4, cfg, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(z, want, rtol=0, atol=1e-6)


def test_run_prior_chain_reduces_each_step_with_mean_fn():
    _, tm = _pair("k37")
    cfg = thmc.HMCConfig(mcmc_steps=3, n_lf=2)
    noise = thmc.draw_hmc_noise(tm, 4, cfg, torch.Generator().manual_seed(0))
    args = (thmc._terms_fn(tm), noise["z0"], noise["gammas"], noise["unifs"], cfg)
    seen = []
    z, rate, lp = thmc.run_prior_chain(*args, mean_fn=lambda a: seen.append(a) or a.max())
    z_d, rate_d, lp_d = thmc.run_prior_chain(*args)
    assert len(seen) == 3 and all(a.dtype == torch.float32 for a in seen)
    assert torch.equal(z, z_d) and torch.equal(lp, lp_d)
    assert float(rate) == float(torch.stack([a.max() for a in seen]).mean())
    assert float(rate_d) == float(torch.stack([a.mean() for a in seen]).mean())


def test_sharded_chain_rejects_an_indivisible_batch():
    _, tm = _pair("k37")
    with pytest.raises(ValueError, match="divide"):
        tmp.sample_prior_hmc_sharded(Mesh(dp=2, ep=1, data_index=0, model_index=0), tm, 7,
                                     thmc.HMCConfig())


def test_sharded_terms_take_the_partials_through_their_wrapper(monkeypatch):
    """Every evaluation of the sharded terms is one ``hmc_partials`` call,
    the wrapper that launches B8 on CUDA tensors (so no path of the module
    reaches the plain partials on the card), and the sharded G^{-1} on
    other devices raises as the wrapper does."""
    _, tm = _pair("k37")
    seen = []
    monkeypatch.setattr(tmp, "hmc_partials", lambda *a: seen.append(a[0].device) or
                        hmc_partials(*a))
    cfg = thmc.HMCConfig(mcmc_steps=2, n_lf=3)
    tmp.sample_prior_hmc_sharded(create_mesh(), tm, 4, cfg,
                                 generator=torch.Generator().manual_seed(0))
    assert seen == [torch.device("cpu")] * (1 + cfg.mcmc_steps * (cfg.n_lf + 1))
    meta = CentroidMetric(tm.centroids.to("meta"), tm.matrices.to("meta"), tm.temperature,
                          tm.regularization)
    with pytest.raises(ValueError, match="unsupported device"):
        tmp.hmc_terms_sharded(create_mesh(), meta, torch.zeros((2, 16), device="meta"))


# ---------------------------------------------------------------------------
# across processes: ep_verify with gloo
# ---------------------------------------------------------------------------


def _write_inputs(path, jm, z, n_chain):
    """ep_verify's inputs: the bank, the rows z, and JAX's draws of one
    short chain per init."""
    arrays = {"centroids": np.asarray(jm.centroids), "matrices": np.asarray(jm.matrices),
              "temperature": np.float32(jm.temperature),
              "regularization": np.float32(jm.regularization),
              "z": z, "chains": np.array(["centroids", "randn"])}
    for init, seed in (("centroids", 7), ("randn", 11)):
        z0, gammas, unifs = _jax_draws(jm, init, n_chain, seed)
        arrays.update({f"{init}_z0": z0, f"{init}_gammas": gammas, f"{init}_unifs": unifs,
                       f"{init}_config": np.array([CHAIN["mcmc_steps"], CHAIN["n_lf"],
                                                   CHAIN["eps_lf"], 1.0])})
    np.savez(path, **arrays)


@pytest.mark.parametrize("world", [2, 4])
def test_ep_verify_across_gloo_processes_matches_jax(tmp_path, world):
    """``world`` ranks on a (world/2) x 2 mesh against a JAX mesh of the same
    shape: terms, G^{-1} and L; both chains against JAX's dense sampler;
    exactly one model-group all-reduce per evaluation on every rank; each
    rank at data index r // 2 and model index r % 2."""
    jm, _ = _pair("k37")
    z = _latents(jm.centroids, 16, seed=world)
    n_chain = 8
    _write_inputs(tmp_path / "inputs.npz", jm, z, n_chain)
    rc = ep_verify.main(["--world", str(world), "--model-parallel", "2", "--device", "cpu",
                         "--out", str(tmp_path), "--timeout", "240"])
    assert rc == 0, [(tmp_path / f"rank{r}.log").read_text()[-2000:] for r in range(world)]
    got = np.load(tmp_path / "result.npz")

    jmesh = jax_create_mesh(n_devices=world, model_parallel=2)
    lp, grad, g_inv, chol = _jax_sharded_all(jmesh, jmp.shard_metric(jmesh, jm), z)
    np.testing.assert_allclose(got["log_pi"], np.asarray(lp), rtol=0, atol=LP_ATOL)
    np.testing.assert_allclose(got["grad"], np.asarray(grad), rtol=0, atol=GRAD_ATOL)
    _within(got["g_inv"], g_inv, GI_REL)
    _within(got["chol"], chol, GI_REL)
    for init, seed in (("centroids", 7), ("randn", 11)):
        want_z, want_rate, _ = _jax_dense_chain("k37", init, n_chain, seed)
        np.testing.assert_allclose(got[f"{init}_z"], want_z, rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(got[f"{init}_accept_rate"]), want_rate, rtol=0,
                                   atol=1e-6)
    evals = 1 + CHAIN["mcmc_steps"] * (CHAIN["n_lf"] + 1)
    for r in range(world):
        rank = np.load(tmp_path / f"rank{r}.npz")
        assert (int(rank["data_index"]), int(rank["model_index"])) == (r // 2, r % 2)
        assert int(rank["terms_model_calls"]) == 1 and int(rank["terms_data_calls"]) == 0
        for init in ("centroids", "randn"):
            assert int(rank[f"{init}_model_calls"]) == evals
            assert int(rank[f"{init}_data_calls"]) == CHAIN["mcmc_steps"]


def test_ep_verify_reports_a_failed_rank(tmp_path, monkeypatch):
    """A rank that cannot run (an indivisible batch) fails the launcher, and
    its error reaches its log; ``--out`` given relative to the working
    directory (the ranks' ``file://`` store takes it made absolute)."""
    jm, _ = _pair("k37")
    _write_inputs(tmp_path / "inputs.npz", jm, _latents(jm.centroids, 3, seed=1), 8)
    monkeypatch.chdir(tmp_path.parent)
    rc = ep_verify.main(["--world", "2", "--model-parallel", "1", "--device", "cpu",
                         "--out", tmp_path.name, "--timeout", "120"])
    assert rc == 1
    assert "must divide" in (tmp_path / "rank0.log").read_text()
