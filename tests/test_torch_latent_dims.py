"""The port at latent widths other than 16, against the JAX package on the CPU.

The JAX package runs its metric kernels at any D <= 32 (``_FUSED_MAX_DIM``)
and takes XLA past it; the port's kernels take the same widths and its call
sites route past 32 as JAX's do.  On the CPU the wrappers run their plain
versions, so these tests hold the arithmetic and the routing to JAX's:

- ``g_inv``, ``chol_g_inv``, ``logdet_g_inv``, ``g`` and the HMC terms at
  D = 2, 8 and 32 against JAX's XLA functions and its Pallas kernels in
  interpret mode (K = 6), at the JAX package's kernel tolerances (G^{-1}
  rtol 1e-5 atol 1e-6; L and logdet 1e-4; G 1e-3; log pi 1e-5; the HMC
  gradient within 1e-4 of its scale);
- the routing predicates (``fused_supported``, ``chain_supported``) against
  JAX's ``fused_supported`` and the shape part of ``_use_fused`` over a grid
  of D and H, and the routes the port's call sites take past 32;
- the zero-padding of the IAF chain's hidden width (H % 4 != 0), exact;
- ``convert.from_jax_variables`` at latent 8 and 32: every leaf carried bit
  for bit;
- the default preset at latent 8 with narrow fp32 nets and near-identity
  flows (log-sigma bias 0: the reference init's -2 amplifies fp32 rounding
  through the chain's gradient far past these limits) on JAX's weights: a
  training forward's losses (rtol 1e-4) and gradients (1e-4 of each leaf's
  scale), and one Adam step (losses and the updated weights, 1e-4 of scale);
- the latent-8 ``reconstruct`` program exported (the registered ops' fake
  shapes follow the inputs): bit for bit the live manager, which equals
  JAX's ``reconstruct`` on the same weights and noise within 1e-5.

Torch runs on one thread; every JAX computation is jitted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.flows.temporal import TemporalFlowConfig
from rlvae_tpu.geometry import metric as jgm
from rlvae_tpu.geometry.metric import CentroidMetric as JaxMetric
from rlvae_tpu.ops import metric_kernels as jmk
from rlvae_tpu_torch.flows import TemporalFlows, apply_temporal_flows
from rlvae_tpu_torch.geometry import metric as tgm
from rlvae_tpu_torch.geometry.metric import CentroidMetric
from rlvae_tpu_torch.ops import iaf_kernels, metric_kernels
from rlvae_tpu_torch.ops._launch import plain_route

torch.set_num_threads(1)

K, B = 6, 5
TOL = {"g_inv": (1e-5, 1e-6), "chol_g_inv": (1e-4, 1e-4), "logdet_g_inv": (1e-4, 1e-4),
       "g": (1e-3, 1e-3)}
LOG_EPS = float(np.log(np.float32(1e-10)))


def _bank(d, k=K, seed=0):
    rng = np.random.default_rng(seed + d)
    c = rng.normal(size=(k, d)).astype(np.float32)
    a = (rng.normal(size=(k, d, d)) / np.sqrt(d)).astype(np.float32)
    m = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)
    return c, (0.5 * (m + np.swapaxes(m, -1, -2))).astype(np.float32)


def _pair(d):
    """(JAX metric, port metric, rows near the centroids) at width d, T = sqrt(d)
    so that every centroid weighs in."""
    c, m = _bank(d)
    t = float(np.sqrt(d))
    rng = np.random.default_rng(d)
    z = (c[rng.integers(0, K, size=B)] + 0.3 * rng.normal(size=(B, d))).astype(np.float32)
    return (JaxMetric.create(c, m, temperature=t, regularization=0.01),
            CentroidMetric.create(c, m, temperature=t, regularization=0.01), z)


@functools.partial(jax.jit, static_argnums=2)
def _jax_metric_functions(metric, z, all_kernels):
    """JAX's XLA metric functions and its Pallas kernels in interpret mode
    (with ``all_kernels``; else, at D = 32, whose unrolled programs take JAX
    ~30 s to compile in all, G and the terms against XLA only and L and the
    log-det against the chol-bundle kernel only)."""
    chol = jmk.chol_bundle_pallas(metric, z, interpret=True)
    out = {
        "xla": {"g_inv": jgm.g_inv(metric, z), "g": jgm._g_xla(metric, z),
                "log_pi": jgm.log_sqrt_det_g_inv(metric, z),
                "grad": jgm.grad_log_sqrt_det_g_inv(metric, z)},
        "pallas": {"g_inv": jmk.g_inv_pallas(metric, z, interpret=True),
                   "chol_g_inv": chol.chol_g_inv, "logdet_g_inv": chol.logdet_g_inv},
    }
    if all_kernels:
        lp, grad = jmk.hmc_terms_pallas(metric, z, interpret=True)
        out["pallas"].update(g=jmk.metric_bundle_pallas(metric, z, interpret=True).g,
                             log_pi=lp, grad=grad)
        out["xla"].update(chol_g_inv=jgm._chol_g_inv_xla(metric, z, 0.0),
                          logdet_g_inv=jgm.logdet_g_inv(metric, z))
    return out


@pytest.mark.parametrize("d", [2, 8, 32])
def test_metric_functions_and_hmc_terms_match_jax(d):
    """Every function against JAX's XLA path and the Pallas kernels (at D =
    32: G^{-1} against both, L and the log-det against B1's kernel, G and the
    terms against XLA), L's lower triangle (the TPU kernels leave the upper
    one unwritten)."""
    jm, pm, z = _pair(d)
    want = jax.tree_util.tree_map(np.asarray,
                                  _jax_metric_functions(jm, jnp.asarray(z), d < 32))
    zt = torch.from_numpy(z)
    got = {"g_inv": tgm.g_inv(pm, zt), "chol_g_inv": tgm.chol_g_inv(pm, zt, jitter=0.0),
           "logdet_g_inv": tgm.logdet_g_inv(pm, zt), "g": tgm.g(pm, zt),
           "log_pi": tgm.log_sqrt_det_g_inv(pm, zt), "grad": tgm.grad_log_sqrt_det_g_inv(pm, zt)}
    terms = metric_kernels.hmc_terms(zt, pm.centroids, pm.matrices, 1.0 / pm.temperature ** 2,
                                     pm.regularization, LOG_EPS)
    assert torch.equal(terms[1], got["grad"])
    lower = np.tril(np.ones((d, d), bool))
    for side, outs in want.items():
        for name, (rtol, atol) in TOL.items():
            if name not in outs:
                continue
            w = np.where(lower, outs[name], 0.0) if name == "chol_g_inv" else outs[name]
            np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=rtol, atol=atol,
                                       err_msg=f"{side} {name} D={d}")
        if "log_pi" in outs:
            np.testing.assert_allclose(terms[0].numpy(), outs["log_pi"], rtol=0, atol=1e-5,
                                       err_msg=f"{side} log pi D={d}")
            scale = float(np.abs(outs["grad"]).max())
            assert float(np.abs(got["grad"].numpy() - outs["grad"]).max()) <= 1e-4 * scale, (
                side, d)


@pytest.mark.parametrize("d", [2, 8, 32, 40])
def test_partials_and_sharded_terms_take_every_width(d):
    """The EP path's shard sums (B8's plain version) at any width, and past
    32 through the plain route; on the 1 x 1 mesh the sharded terms equal the
    dense ones."""
    from rlvae_tpu_torch.parallel import create_mesh, hmc_terms_sharded, shard_metric

    jm, pm, z = _pair(d)
    zt = torch.from_numpy(z)
    gi, v = metric_kernels.hmc_partials(zt, pm.centroids, pm.matrices, 1.0 / pm.temperature ** 2)
    assert gi.shape == (B, d, d) and v.shape == (B, d)
    mesh = create_mesh()
    lp, grad = hmc_terms_sharded(mesh, shard_metric(mesh, pm), zt)
    torch.testing.assert_close(lp, tgm.log_sqrt_det_g_inv(pm, zt), rtol=0, atol=1e-5)
    want = tgm.grad_log_sqrt_det_g_inv(pm, zt)
    assert float((grad - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_routing_predicates_match_jax(monkeypatch):
    """``fused_supported`` is JAX's over D = 1..64; ``chain_supported`` is the
    shape part of JAX's ``_use_fused`` (its TPU branch, density direction,
    n_hidden 3) over D = 1..64 and H in a grid around 256."""
    for d in range(1, 65):
        c = np.zeros((2, d), np.float32)
        jm = JaxMetric.create(c, np.broadcast_to(np.eye(d, dtype=np.float32), (2, d, d)))
        assert metric_kernels.fused_supported(d) == jmk.fused_supported(jm), d
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for d in (1, 2, 16, 31, 32, 33, 48, 64):
        for h in (1, 3, 4, 30, 100, 255, 256, 257, 300, 512):
            cfg = TemporalFlowConfig(d, n_flows=1, hidden_size=h, n_hidden=3)
            assert iaf_kernels.chain_supported(d, h) == cfg._use_fused(), (d, h)


def test_call_sites_route_by_width(monkeypatch):
    """On the CPU the routes are the plain versions either way (no count:
    ``plain_route.calls`` counts CUDA tensors); past 32 the metric functions
    never reach a wrapper, whose kernel would raise on the card."""
    _, pm, z = _pair(40)
    zt = torch.from_numpy(z)
    called = []
    for name in ("chol_bundle", "metric_bundle", "g_inv", "hmc_terms"):
        fn = getattr(metric_kernels, name)
        monkeypatch.setattr(metric_kernels, name,
                            lambda *a, _n=name, _f=fn: called.append(_n) or _f(*a))
    before = plain_route.calls
    out = (tgm.g_inv(pm, zt), tgm.chol_g_inv(pm, zt), tgm.logdet_g_inv(pm, zt), tgm.g(pm, zt),
           *tgm.g_inv_and_g(pm, zt), tgm.grad_log_sqrt_det_g_inv(pm, zt))
    assert called == [] and plain_route.calls == before
    assert all(torch.isfinite(t).all() for t in out)
    _, pm8, z8 = _pair(8)
    tgm.g_inv(pm8, torch.from_numpy(z8))
    assert called == ["g_inv"]  # inside the envelope the site calls the wrapper


def test_padded_bank_pads_once_per_bank():
    """The kernels' bank at a width below its compiled one: zero-padded in its
    trailing indices (``pad_bank``).  The metric pads it once and keeps the
    pair while its tensors are unchanged (meta tensors stand in for the
    card's), re-pads after an in-place change or a new tensor, and hands the
    bank itself on the CPU, at a compiled width and past 32.  The wrappers
    take either form: a bank of width D or of D's compiled width."""
    c, m = (torch.from_numpy(a) for a in _bank(24))
    pc, pm_ = metric_kernels.pad_bank(c, m, 32)
    assert pc.shape == (K, 32) and pm_.shape == (K, 32, 32)
    assert torch.equal(pc[:, :24], c) and torch.all(pc[:, 24:] == 0)
    assert torch.equal(pm_[:, :24, :24], m) and torch.all(pm_[:, 24:] == 0)
    assert torch.all(pm_[:, :, 24:] == 0)
    metric = CentroidMetric(c.to("meta"), m.to("meta"), 0.1, 0.01)
    first = metric.kernel_bank()
    assert first[0].shape == (K, 32) and first[1].shape == (K, 32, 32)
    assert all(a is b for a, b in zip(metric.kernel_bank(), first))
    metric.matrices.add_(1.0)
    again = metric.kernel_bank()
    assert again[1] is not first[1] and metric.kernel_bank()[1] is again[1]
    metric.centroids = c.to("meta")
    assert metric.kernel_bank()[0] is not again[0]
    for d, dev in ((24, "cpu"), (32, "meta"), (16, "meta"), (40, "meta")):
        cd, md = (torch.from_numpy(a).to(dev) for a in _bank(d))
        bank = CentroidMetric(cd, md, 0.1, 0.01).kernel_bank()
        assert bank[0] is cd and bank[1] is md, (d, dev)
    assert [metric_kernels.bank_width(d) for d in (1, 16, 17, 32)] == [16, 16, 32, 32]
    z = torch.zeros((3, 24))
    assert metric_kernels._check_bank_shapes("g_inv", z, c, m) == (3, K, 24)
    assert metric_kernels._check_bank_shapes("g_inv", z, pc, pm_) == (3, K, 24)
    with pytest.raises(ValueError):
        metric_kernels._check_bank_shapes("g_inv", z[:, :8], pc, pm_)


def test_width_32_geometry_rule():
    """The Python mirror of the width-32 rule: chunks of 2 centroids, at most
    4 rows and 8 warps a CTA; the width-16 rule unchanged."""
    slots = lambda rows, warps, ctas: 16  # noqa: E731
    for b in (1, 37, 64, 1000, 4096):
        for k in (1, 50, 200, 2000, 20_000):
            g = metric_kernels.hmc_geometry(b, k, 132, slots, "hmc_terms", 32)
            c_max = max(1, min(8, (-(-k // 2)) // 32))
            assert g.rows <= 4 and g.warps <= 8 and g.ctas <= c_max and g.clusters == -(-b // g.rows)
            assert (metric_kernels.hmc_geometry(b, k, 132, slots, "g_inv", 24)
                    == metric_kernels.hmc_geometry(b, k, 132, slots, "metric_bundle", 32))
            assert metric_kernels.hmc_geometry(b, k, 132, slots, "hmc_terms", 16) == (
                metric_kernels.hmc_geometry(b, k, 132, slots))
    assert [metric_kernels.BANK_KERNELS[k] for k in ("hmc_terms", "hmc_partials", "chol_bundle",
                                                     "metric_bundle", "g_inv")] == [0, 0, 1, 2, 2]


def test_gradient_through_the_terms_is_refused_only_on_the_kernel():
    """B4 has no backward: a chain autograd would differentiate off the CPU
    (meta tensors stand in for the card's) raises at D <= 32; past 32 the
    terms are the plain, differentiable ones, as JAX's XLA terms."""
    from rlvae_tpu_torch.samplers import hmc as thmc

    for d, refused in ((8, True), (40, False)):
        _, pm, _ = _pair(d)
        meta = torch.zeros((2, d), device="meta", requires_grad=True)
        if refused:
            with pytest.raises(NotImplementedError, match="backward"):
                thmc.refuse_grad_through_terms(pm, meta)
        else:
            thmc.refuse_grad_through_terms(pm, meta)


@pytest.mark.parametrize("d,h", [(6, 30), (16, 2), (16, 254)])
def test_hidden_padding_is_exact(d, h):
    """``pad_hidden`` (H % 4 != 0 -> zero-weight units) leaves the chain's
    outputs as they were, and its gradient flows back to the real weights."""
    torch.manual_seed(0)
    flows = TemporalFlows(d, n_flows=2, hidden_size=h, log_var_bias_init=0.0)
    chain = [flows.flows[min(t, 1)] for t in range(3)]
    stack = iaf_kernels.stack_chain(chain)
    padded = iaf_kernels.pad_hidden(stack)
    assert padded[0].shape[-1] % 4 == 0 and padded[0].shape[-1] - h < 4
    z0 = torch.randn(5, d)
    want = iaf_kernels.iaf_chain_fwd_ref(z0, *stack)
    got = iaf_kernels.iaf_chain_fwd_ref(z0, *padded)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    z, ld = iaf_kernels.IAFChain.apply(z0, *padded, 0)
    (z.sum() + ld.sum()).backward()
    assert all(p.grad is not None for p in flows.parameters() if p.requires_grad)


def test_chain_past_the_envelope_takes_the_plain_transitions():
    """D > 32 or H > 256: one ``iaf_forward`` per transition, as JAX's XLA
    route, equal to the chain's plain version on the same weights."""
    from rlvae_tpu_torch.flows.iaf import iaf_forward

    torch.manual_seed(1)
    for d, h in ((40, 16), (6, 300)):
        flows = TemporalFlows(d, n_flows=2, hidden_size=h, log_var_bias_init=0.0)
        z0 = torch.randn(3, d)
        z_seq, lds = apply_temporal_flows(flows, z0, 4)
        z, ld = z0, []
        for t in range(3):
            z, l_t = iaf_forward(flows.flows[min(t, 1)], z)
            torch.testing.assert_close(z_seq[:, t + 1], z, rtol=0, atol=0)
            ld.append(l_t)
        torch.testing.assert_close(lds, torch.stack(ld, 1), rtol=0, atol=0)
        chain = iaf_kernels.iaf_chain_fwd_ref(z0, *iaf_kernels.stack_chain(
            [flows.flows[min(t, 1)] for t in range(3)]))
        torch.testing.assert_close(z_seq[:, 1:], chain[0].transpose(0, 1), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# whole models at latent 8
# ---------------------------------------------------------------------------

NET = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
T, NB = 4, 4
LOSSES = ("loss", "recon_loss", "kld_loss", "flow_loss", "loop_penalty")


def _config(metric_path, d=8):
    from rlvae_tpu_torch.models import PRESETS

    return {**PRESETS["riemannian_flow_vae"], "input_dim": [3, 8, 8], "latent_dim": d,
            "n_flows": 2, "flow_hidden_size": 32, "encoder": NET, "decoder": NET,
            "flow_log_var_bias_init": 0.0,
            "pretrained": {"encoder_path": None, "decoder_path": None,
                           "metric_path": str(metric_path)}}


def _write_bank(path, d, k=5):
    c, m = _bank(d, k, seed=3)
    np.savez(path, centroids=c, M_matrices=m, temperature=np.float32(1.0),
             regularization=np.float32(0.01))
    return path


@pytest.fixture(scope="module")
def latent8(tmp_path_factory):
    """(JAX manager, a maker of the port's model): the default preset at latent 8,
    3x8x8 frames, 2 flows of width 32, fp32 MLP nets of width 32, a seeded
    K=5 bank in 8-D; the port carries JAX's variables."""
    from rlvae_tpu.inference import ModelManager as JaxManager
    from rlvae_tpu_torch.convert import from_jax_variables
    from rlvae_tpu_torch.models import create_model

    cfg = _config(_write_bank(tmp_path_factory.mktemp("bank") / "metric.npz", 8))
    jm = JaxManager.from_config(cfg, seed=0)

    def port():
        pm = create_model(cfg)
        pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jm.variables)))
        return pm

    return jm, port


def _seqs(seed=1):
    return np.random.default_rng(seed).uniform(size=(NB, T, 3, 8, 8)).astype(np.float32)


def _jax_eps(key, d=8):
    return torch.tensor(np.asarray(jax.random.normal(jax.random.split(key)[0], (NB, d))))


def _close_scaled(got, want, rtol, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, i)
        scale = max(float(np.abs(b).max()), 1e-12)
        assert float(np.abs(a - b).max()) <= rtol * scale, (what, i, float(np.abs(a - b).max()),
                                                             scale)


@pytest.mark.parametrize("d", [8, 32])
def test_convert_carries_any_latent_width(d, tmp_path):
    """JAX's variables of the preset at latent d load into the port's model
    strictly, and come back out leaf for leaf."""
    from rlvae_tpu.models import create_model as jax_create_model
    from rlvae_tpu_torch.convert import from_jax_variables, jax_leaves, params_to_numpy
    from rlvae_tpu_torch.models import create_model

    cfg = _config(_write_bank(tmp_path / "metric.npz", d), d)
    jv = jax.tree_util.tree_map(np.asarray, jax.jit(jax_create_model(cfg).init)(
        jax.random.PRNGKey(0)))
    pm = create_model(cfg)
    pm.load_state_dict(from_jax_variables(jv), strict=True)
    assert pm.latent_dim == d and pm.metric.latent_dim == d
    got = dict(jax_leaves(params_to_numpy(pm)))
    want = dict(jax_leaves(jv["params"]))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name], leaf, err_msg=name)


def test_latent8_train_forward_and_step_match_jax(latent8):
    from rlvae_tpu.train import optim as jopt
    from rlvae_tpu.train.trainer import make_train_step as jax_make_train_step
    from rlvae_tpu_torch.convert import params_to_numpy
    from rlvae_tpu_torch.train import make_optimizer, make_train_step

    jmgr, port = latent8
    jm, pm = jmgr.model, port()
    jv = jax.tree_util.tree_map(jnp.asarray, jmgr.variables)
    x = _seqs()
    key = jax.random.PRNGKey(5)

    @jax.jit
    def forward_and_step(jv, x):
        def loss(p):
            o = jm.forward({**jv, "params": p}, x, key, train=True)
            return o.loss, {t: o[t] for t in LOSSES}

        (_, terms), grads = jax.value_and_grad(loss, has_aux=True)(jv["params"])
        opt = jopt.make_optimizer(1e-3, 1e-4)
        new_v, _, metrics = jax_make_train_step(jm, opt)(jv, opt.init(jv["params"]), x, key)
        return terms, grads, new_v["params"], metrics

    terms, grads, new_params, jmet = jax.tree_util.tree_map(
        np.asarray, forward_and_step(jv, jnp.asarray(x)))
    pm.train()
    pm.zero_grad(set_to_none=True)
    out = pm(torch.from_numpy(x), _jax_eps(key), train=True)
    out.loss.backward()
    for k in LOSSES:
        np.testing.assert_allclose(float(out[k].detach()), float(terms[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    g = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in
         pm.named_parameters()}
    _close_scaled(jax.tree_util.tree_leaves(_tree_like(pm, g)), jax.tree_util.tree_leaves(grads),
                  1e-4, "gradients")
    pmet = make_train_step(pm, make_optimizer(pm.parameters(), 1e-3, 1e-4))(
        torch.from_numpy(x), _jax_eps(key))
    for k in LOSSES:
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=f"step {k}")
    _close_scaled(jax.tree_util.tree_leaves(params_to_numpy(pm)),
                  jax.tree_util.tree_leaves(new_params), 1e-4, "updated weights")


def _tree_like(model, tensors):
    """``params_to_numpy`` of ``model`` with its parameters replaced by ``tensors``."""
    import copy

    from rlvae_tpu_torch.convert import params_to_numpy

    other = copy.deepcopy(model)
    for name, p in other.named_parameters():
        p.data = tensors[name].detach().clone()
    return params_to_numpy(other)


def test_latent8_reconstruct_export_equals_the_manager_and_jax(latent8, tmp_path, monkeypatch):
    """The latent-8 ``reconstruct`` program exports (its registered ops' fake
    shapes follow z), equals the live manager bit for bit at a full bucket,
    and the manager equals JAX's ``reconstruct`` on the same weights and
    noise."""
    from rlvae_tpu_torch.export import export_model, load_exported

    from rlvae_tpu_torch import ModelManager

    jmgr, port = latent8
    mgr = ModelManager(port(), "cpu")
    x = _seqs(seed=2)
    manifest = export_model(mgr, tmp_path, ops=("reconstruct",), buckets=(NB,), n_obs=T)
    assert set(manifest["programs"]) == {"reconstruct"}
    ops = manifest["programs"]["reconstruct"][str(NB)]["registered_ops"]
    assert ops["chol_bundle"] == 2 and ops["iaf_chain_fwd"] == 1, ops
    loaded = load_exported(tmp_path, device="cpu")
    np.testing.assert_array_equal(loaded.run("reconstruct", x), mgr.reconstruct(x, seed=0))
    want = jmgr.reconstruct(x, seed=0)
    eps = _jax_eps(jax.random.PRNGKey(0))
    monkeypatch.setattr(mgr.model, "draw_posterior_noise", lambda n, gen=None: {"eps": eps[:n]})
    np.testing.assert_allclose(mgr.reconstruct(x, seed=0), want, rtol=0, atol=1e-5)
