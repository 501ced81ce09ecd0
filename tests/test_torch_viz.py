"""The port's visualization modules (``rlvae_tpu_torch/viz/``) against the
JAX package's on the CPU, and the port's slope timers
(``rlvae_tpu_torch/utils/profiling.py``; JAX's tests/test_utils.py:145-200).

The model is tests/test_viz.py's (3x8x8 frames, latent 16, 3 flows of
hidden 32, the shipped K=50 metric at T=3.0) with fp32 MLP nets of hidden
32, built by JAX and carried to the port by ``convert.from_jax_variables``.
Both sides plot the same forward: the port's, whose latents and
reconstructions replace each JAX module's ``forward``.  JAX's geometry
calls are wrapped to record their inputs and outputs while JAX's ``run``
lays out its figures (drawn only by the port's runs here), and each
recorded array is held to the port's field: ``log_sqrt_det_g_inv``,
``g_inv``, ``g``, ``dist2``, ``logdet_g_inv`` and ``path_length`` at
FIELD_TOL of max(1, |x|) (JAX's metric functions run on rows padded to one
shape, so that each compiles once), the flows' Jacobian spectra at
SPECTRA_TOL (relative), the decoded and generated frames (JAX's own draws)
at GEN_ATOL.  JAX's eager ``gaussian_curvature_2d`` costs ~20 s a call at
any grid size and its ``energy_path`` ~9 s of compiling, so their wrappers
record the inputs and return zeros and the straight line: the port's
modules must hand the port's functions the same inputs (plane, grids,
endpoints, points, steps) and show what those return, and the functions
themselves are held to JAX's in tests/test_torch_geodesics.py (curvature,
whole energy paths) and tests/test_torch_inference_extras.py.  The torch
work runs on one thread here (the test suite runs six worker processes at once).
"""

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlvae_tpu.geometry as jgeo
import rlvae_tpu.geometry.curvature as jcurv
import rlvae_tpu.geometry.geodesics as jgeod
from rlvae_tpu.geometry import load_metric as jax_load_metric
from rlvae_tpu.models.rlvae import RlVAE as JaxRlVAE
from rlvae_tpu.viz import VisualizationConfig as JaxVizConfig
from rlvae_tpu.viz import VisualizationLevel as JaxVizLevel
from rlvae_tpu.viz.flow_analysis import FlowAnalysisVisualizations as JaxFlow
from rlvae_tpu.viz.interactive import InteractiveVisualizations as JaxInteractive
from rlvae_tpu.viz.manifold import ManifoldVisualizations as JaxManifold
from rlvae_tpu_torch.convert import from_jax_variables
from rlvae_tpu_torch.geometry import load_metric
from rlvae_tpu_torch.models import RlVAE
from rlvae_tpu_torch.utils.profiling import auto_slope_time, fori_slope_time, scan_slope_time
from rlvae_tpu_torch.viz import VisualizationConfig, VisualizationLevel
from rlvae_tpu_torch.viz.base import SharedForward
from rlvae_tpu_torch.viz.basic import BasicVisualizations
from rlvae_tpu_torch.viz.flow_analysis import FlowAnalysisVisualizations
from rlvae_tpu_torch.viz.interactive import InteractiveVisualizations
from rlvae_tpu_torch.viz.manifold import ManifoldVisualizations

METRIC = Path(__file__).resolve().parents[1] / "data" / "pretrained" / "metric_T0.7_scaled.npz"
FIELD_TOL = 1e-5
SPECTRA_TOL = 1e-4
GEN_ATOL = 5e-4
VIZ = dict(enable_basic=True, enable_manifold=True, enable_interactive=True,
           enable_flow_analysis=True, enable_fancy_plots=True, disable_curvature=False,
           max_sequences=4, log_to_wandb=False)
GEOMETRY = ("log_sqrt_det_g_inv", "g_inv", "g", "dist2", "logdet_g_inv")
PAD_ROWS = 3600  # the largest grid's rows


def _close(got, want, tol=FIELD_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))
    assert err <= tol, err


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
    kw = dict(input_dim=(3, 8, 8), latent_dim=16, n_flows=3, flow_hidden_size=32,
              posterior_type="riemannian_metric", encoder_config=net, decoder_config=net)
    jm = JaxRlVAE(metric=jax_load_metric(METRIC, temperature_override=3.0), **kw)
    jv = jm.init(jax.random.PRNGKey(0), n_obs=4)
    pm = RlVAE(metric=load_metric(METRIC, temperature_override=3.0), **kw)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, jv)))
    x = np.random.default_rng(0).uniform(size=(4, 4, 3, 8, 8)).astype(np.float32)
    out = SharedForward()(pm, x, 0)
    z, recon = out.z.numpy(), out.recon_x.numpy()
    cfg = VisualizationConfig(level=VisualizationLevel.FULL, **VIZ)
    jcfg = JaxVizConfig(level=JaxVizLevel.FULL, **VIZ)
    return types.SimpleNamespace(jm=jm, jv=jv, pm=pm, x=x, z=z, recon=recon, cfg=cfg, jcfg=jcfg,
                                 out=tmp_path_factory.mktemp("viz"))


def _padded(fn):
    """``fn(metric, *rows)`` on the rows padded to PAD_ROWS (the first row
    repeated), the output cut back: the metric's functions treat rows
    alone, and one padded shape compiles once for every grid."""

    def call(metric, *zs):
        n = zs[0].shape[0]
        pad = [jnp.concatenate([z, jnp.repeat(z[:1], PAD_ROWS - n, 0)]) for z in zs]
        return fn(metric, *pad)[:n]

    return call


class _Recorder:
    """JAX's geometry functions wrapped: every call's arguments and output."""

    def __init__(self, mp):
        self.calls = []
        for name in GEOMETRY:
            mp.setattr(jgeo, name, self._wrap(name, _padded(getattr(jgeo, name))))
        mp.setattr(jgeod, "path_length", self._wrap("path_length", jgeod.path_length))
        mp.setattr(jgeod, "energy_path", self._wrap("energy_path", _straight))
        mp.setattr(jcurv, "gaussian_curvature_2d", self._wrap(
            "gaussian_curvature_2d", lambda metric, basis, origin, pts: jnp.zeros(pts.shape[0])))
        generate = JaxRlVAE.generate

        def recorded_generate(model, variables, key, *a, **k):
            out = generate(model, variables, key, *a, **k)
            self.calls.append(("generate", (key,), {}, np.asarray(out)))
            return out

        mp.setattr(JaxRlVAE, "generate", recorded_generate)

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((name, args, kwargs, np.asarray(out)))
            return out
        return wrapped

    def of(self, name):
        return [(args, out) for n, args, _, out in self.calls if n == name]

    def kwargs_of(self, name):
        return [kwargs for n, _, kwargs, _ in self.calls if n == name]


def _straight(metric, z0, z1, n_points=16, n_iters=200, lr=0.05):
    """The straight line between z0 and z1 in place of JAX's energy path."""
    t = jnp.linspace(0.0, 1.0, n_points)[:, None]
    return (1.0 - t) * z0[None] + t * z1[None]


class _PortCalls:
    """The port's curvature and energy path wrapped: every call's inputs."""

    def __init__(self, mp):
        import rlvae_tpu_torch.geometry.curvature as tcurv
        import rlvae_tpu_torch.geometry.geodesics as tgeod

        self.calls = []
        for mod, name in ((tcurv, "gaussian_curvature_2d"), (tgeod, "energy_path")):
            fn = getattr(mod, name)

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                self.calls.append((_name, args, kwargs))
                return _fn(*args, **kwargs)

            mp.setattr(mod, name, wrapped)

    def of(self, name):
        return [(args, kwargs) for n, args, kwargs in self.calls if n == name]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The torch work on one thread (the test suite runs six worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Each JAX module's ``run`` at FULL on the port's forward, its geometry
    calls recorded; the flow module's spectra read off ``_flow_animation``."""
    from matplotlib.figure import Figure

    fixed = types.SimpleNamespace(z=jnp.asarray(setup.z), recon_x=jnp.asarray(setup.recon))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        # JAX's figures are laid out but not drawn: the port's run renders below
        mp.setattr(Figure, "savefig", lambda self, fname, **k: Path(fname).touch()
                   if isinstance(fname, (str, Path)) else None)
        mp.setattr(Figure, "tight_layout", lambda self, **k: None)
        for name, cls in (("manifold", JaxManifold), ("flow", JaxFlow),
                          ("interactive", JaxInteractive)):
            module = cls(setup.jcfg, setup.out / f"jax_{name}", None)
            module.forward = lambda *a, **k: fixed
            spectra = []
            if name == "flow":
                animate = module._flow_animation
                module._flow_animation = lambda e, m, z, s: spectra.extend(s) or animate(e, m, z, s)
            with pytest.MonkeyPatch.context() as per_run:
                rec = _Recorder(per_run)
                written = module.run(0, setup.jm, setup.jv, setup.x)
            runs[name] = types.SimpleNamespace(rec=rec, written=written, spectra=spectra)
    return runs


@pytest.fixture(scope="module")
def fields(setup):
    """Each port module's fields of the forward's latents, with the inputs
    each handed the curvature and the energy path."""
    make = lambda cls: cls(setup.cfg, setup.out / "fields", None)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        calls = _PortCalls(mp)
        out = types.SimpleNamespace(
            manifold=make(ManifoldVisualizations).fields(setup.pm, setup.z),
            flow=make(FlowAnalysisVisualizations).fields(setup.pm, setup.z),
            interactive=make(InteractiveVisualizations).fields(setup.pm, setup.z))
    out.calls = calls
    return out


def _names(paths):
    return {p.name for p in paths if p is not None}


# ---------------------------------------------------------------------------
# fields against JAX's
# ---------------------------------------------------------------------------


def test_basic_fields(setup):
    """The basic module's device work is the shared forward alone; its
    fields are host statistics of it (JAX's expressions)."""
    x, recon, z = setup.x, setup.recon, setup.z
    f = BasicVisualizations(setup.cfg, setup.out / "f", None).fields(x, recon, z)
    assert f["proj"].shape == (4, 4, 2) and f["psnr"].shape == (4, 4)
    np.testing.assert_array_equal(f["mse_latent"], np.mean((z[:, 0] - z[:, -1]) ** 2, axis=1))
    np.testing.assert_array_equal(f["per_t"], np.mean((recon - x) ** 2, axis=(0, 2, 3, 4)))
    assert all(np.isfinite(v).all() for v in f.values())


def test_manifold_fields_match_jax(setup, jax_runs, fields):
    rec = jax_runs["manifold"].rec
    f = fields.manifold
    (grid_args, grid), (flat_args, dets) = rec.of("log_sqrt_det_g_inv")
    _close(f["vals"].ravel(), grid)
    _close(f["dets"].ravel(), dets)
    np.testing.assert_array_equal(np.asarray(flat_args[1]), setup.z.reshape(-1, 16))
    ((_, gi),) = rec.of("g_inv")
    _close(f["g_inv"], gi)
    ((args, _),) = rec.of("gaussian_curvature_2d")
    assert f["curv"].shape == (30, 30) and np.isfinite(f["curv"]).all()
    _close(np.stack([f["cgx"].ravel(), f["cgy"].ravel()], 1), args[3])


def test_flow_analysis_fields_match_jax(setup, jax_runs, fields):
    run = jax_runs["flow"]
    f = fields.flow
    assert len(f["spectra"]) == len(run.spectra) == 3
    for got, want in zip(f["spectra"], run.spectra):
        np.testing.assert_allclose(got, want, rtol=SPECTRA_TOL, atol=0)
    ((_, dets),) = run.rec.of("log_sqrt_det_g_inv")
    ((_, ld),) = run.rec.of("logdet_g_inv")
    _close(f["dets"].ravel(), dets)
    _close(f["logdet"].ravel(), ld)


def test_interactive_fields_match_jax(setup, jax_runs, fields):
    rec = jax_runs["interactive"].rec
    f = fields.interactive
    dets = rec.of("log_sqrt_det_g_inv")
    assert len(dets) == 6 + 2 + 2  # slider temperatures, temporal, fancy field and paths
    for got, (args, want) in zip(f["metric_slider"]["vals"], dets[:6]):
        _close(got.ravel(), want)
    np.testing.assert_allclose(f["metric_slider"]["temperatures"],
                               [float(args[0].temperature) for args, _ in dets[:6]], rtol=1e-6)
    _close(f["temporal"]["field"].ravel(), dets[6][1])
    _close(f["temporal"]["dets"].ravel(), dets[7][1])
    fancy = f["fancy"]
    _close(fancy["det_field"].ravel(), dets[8][1])
    _close(fancy["det_path"].ravel(), dets[9][1])
    ((_, g_full),) = rec.of("g")
    _close(fancy["g_full"], g_full)
    (_, riem2), (_, amp2) = rec.of("dist2")
    _close(fancy["riem"].ravel() ** 2, np.maximum(riem2, 0))
    _close(fancy["amp2"], amp2 / 1e-4, 1e-4)  # a difference of nearby points, scaled by 1e4
    (_, l_line), (args, l_l) = rec.of("path_length")  # JAX's geodesic is the straight line
    _close(fancy["geodesic"]["l_l"], l_l)
    _close(fancy["geodesic"]["lin"], args[1])
    _close(l_line, l_l)


def test_geodesic_slider_and_generate_match_jax(setup, jax_runs):
    rec = jax_runs["interactive"].rec
    mod = InteractiveVisualizations(setup.cfg, setup.out / "f", None)
    z_a, z_b = setup.z[0, 0], setup.z[1, 0]
    path = np.stack([(1 - t) * z_a + t * z_b for t in np.linspace(0.0, 1.0, 9)])
    want, _ = setup.jm.decode(setup.jv, jnp.asarray(path))
    np.testing.assert_allclose(mod.geodesic_frames(setup.pm, setup.z),
                               np.asarray(want.reconstruction), rtol=0, atol=GEN_ATOL)
    ((key,), frames) = next((args, out) for n, args, _, out in rec.calls if n == "generate")
    kc = setup.jm.metric.n_centroids
    k1, k2, k3, k4 = jax.random.split(key, 4)
    noise = {"i1": jax.random.randint(k1, (4,), 0, kc), "i2": jax.random.randint(k2, (4,), 0, kc),
             "t": jax.random.uniform(k3, (4, 1)), "eps": jax.random.normal(k4, (4, 16))}
    noise = {k: torch.tensor(np.asarray(v)) for k, v in noise.items()}
    got = mod.generated(setup.pm, 0, 4, noise=noise)
    assert got.shape == frames.shape == (4, 4, 3, 8, 8)
    np.testing.assert_allclose(got, frames, rtol=0, atol=GEN_ATOL)


def test_curvature_and_geodesic_inputs_match_jax(setup, jax_runs, fields):
    """The port's modules hand ``gaussian_curvature_2d`` the plane and grids
    JAX's modules hand theirs (the manifold's 30 x 30, the fancy figure's
    24 x 24) and ``energy_path`` JAX's endpoints, points and steps; their
    fields are what the port's functions return on those inputs (the
    functions are held to JAX's in tests/test_torch_geodesics.py)."""
    import rlvae_tpu_torch.geometry.curvature as tcurv

    jax_curv = (jax_runs["manifold"].rec.of("gaussian_curvature_2d")
                + jax_runs["interactive"].rec.of("gaussian_curvature_2d"))
    port_curv = fields.calls.of("gaussian_curvature_2d")
    assert len(jax_curv) == len(port_curv) == 2
    got = (fields.manifold["curv"], fields.interactive["fancy"]["curvature"]["curv"])
    for (j_args, _), (p_args, _), curv in zip(jax_curv, port_curv, got):
        for i in (1, 2, 3):  # basis, origin, points
            _close(p_args[i].numpy(), j_args[i])
        idx = np.linspace(0, curv.size - 1, 3).astype(int)
        want = tcurv.gaussian_curvature_2d(setup.pm.metric, *p_args[1:3], p_args[3][idx])
        np.testing.assert_array_equal(curv.ravel()[idx], want.numpy())
    ((j_args, _),) = jax_runs["interactive"].rec.of("energy_path")
    ((p_args, p_kwargs),) = fields.calls.of("energy_path")
    for i in (1, 2):  # the endpoints: sequence 0's first and last latents
        _close(p_args[i].numpy(), j_args[i])
    (j_kwargs,) = jax_runs["interactive"].rec.kwargs_of("energy_path")
    assert p_kwargs == j_kwargs == {"n_points": 16, "n_iters": 120}
    geo = fields.interactive["fancy"]["geodesic"]["geo"]
    assert geo.shape == (16, 16) and np.isfinite(geo).all()
    _close(geo[[0, -1]], np.stack([j_args[1], j_args[2]]))


# ---------------------------------------------------------------------------
# rendering on the CPU
# ---------------------------------------------------------------------------

ARTIFACTS = {
    "basic": (BasicVisualizations, {"reconstructions.png", "cyclicity.png", "trajectories.png",
                                    "cyclicity_analysis.png", "reconstruction_analysis.png"}),
    "manifold": (ManifoldVisualizations, {"manifold_heatmap.png", "curvature.png",
                                          "temporal_metric.png", "enhanced_heatmaps.png",
                                          "temporal_metric_analysis.png"}),
    "interactive": (InteractiveVisualizations, {
        "sequence_slider.html", "geodesic_slider.html", "metric_slider.html",
        "temporal_animation.html", "latent_space_explorer.html", "latent_explorer.html",
        "fancy_geodesics.png"}),
    "flow": (FlowAnalysisVisualizations, {"flow_jacobians.png", "flow_det_evolution.png",
                                          "flow_animation.html"}),
}


@pytest.mark.parametrize("name", ARTIFACTS)
def test_port_run_writes_the_artifacts(setup, jax_runs, name, monkeypatch):
    """The port's ``run`` renders the files tests/test_viz.py names, as JAX's
    run wrote them; the manifold's and fancy curvature (plain ops) are
    stubbed to their shape here, their values held above."""
    import rlvae_tpu_torch.geometry.curvature as tcurv

    monkeypatch.setattr(tcurv, "gaussian_curvature_2d",
                        lambda metric, basis, origin, pts: torch.zeros(pts.shape[0]))
    cls, names = ARTIFACTS[name]
    written = cls(setup.cfg, setup.out / f"port_{name}", None).run(0, setup.pm, None, setup.x)
    assert names <= _names(written)
    if name in jax_runs:
        assert _names(written) == _names(jax_runs[name].written)


def test_html_templates_are_jax_s():
    import rlvae_tpu.viz.interactive as jint

    import rlvae_tpu_torch.viz.interactive as tint

    assert tint._SLIDER_HTML == jint._SLIDER_HTML
    assert tint._EXPLORER_HTML == jint._EXPLORER_HTML


def test_interactive_explorer_embeds_images_and_hover(setup):
    mod = InteractiveVisualizations(setup.cfg, setup.out / "explorer", None)
    path = mod._html_latent_explorer(0, setup.z, setup.recon)
    html = path.read_text()
    assert html.count("data:image/png;base64,") == 1 and "mouseenter" in html
    assert html.count('"img": "') == 16  # one embedded frame per point of 4 sequences x 4 steps


# ---------------------------------------------------------------------------
# the slope timers (JAX's tests/test_utils.py:145-200)
# ---------------------------------------------------------------------------


def test_scan_slope_time_cancels_dispatch_cost():
    batches = torch.arange(24 * 64, dtype=torch.float32).reshape(24, 64) / 100.0
    per_call, diag = scan_slope_time(torch.tanh, batches, m_small=4, reps=2)
    assert per_call > 0.0
    assert diag["m_big"] == 24 and diag["m_small"] == 4
    assert diag["t_big_s"] >= per_call * 24 * 0.5
    assert diag["dispatch_overhead_s"] >= 0.0
    assert set(diag) == {"t_small_s", "t_big_s", "m_small", "m_big", "dispatch_overhead_s"}
    # a tree of inputs and of outputs
    tree = {"a": batches, "b": (batches * 2,)}
    per_call, _ = scan_slope_time(lambda t: (t["a"] + t["b"][0], {"s": t["a"].sum()}), tree,
                                  m_small=4, reps=2)
    assert per_call > 0.0


def test_scan_slope_time_rejects_tiny_stack():
    with pytest.raises(ValueError):
        scan_slope_time(lambda x: x, torch.ones(4, 2), m_small=8)


def test_fori_slope_time_two_lengths():
    seen = []

    def body(i, carry):
        seen.append(int(i))
        return carry + torch.tanh(carry + i.float())

    per_iter, diag = fori_slope_time(body, torch.tensor(0.1), n_small=4, n_big=64, reps=2)
    assert per_iter > 0.0
    assert diag["t_big_s"] >= diag["t_small_s"] * 0.5
    assert diag["dispatch_overhead_s"] >= 0.0
    assert (diag["n_small"], diag["n_big"]) == (4, 64)
    assert seen[-64:] == list(range(64))  # i counts from 0 in every run


def test_auto_slope_time_pilot_and_doubling(monkeypatch):
    """The pilot at (n_small, 16); a slow body stops there, a fast one
    re-measures at a trip count sized from the pilot and doubles it at most
    twice while the delta stays under 20% of the target."""
    import rlvae_tpu_torch.utils.profiling as prof

    calls = []

    def fake(body, carry0, n_small=4, n_big=16, reps=5, pilot=1e-6, later=1e-6):
        calls.append(n_big)
        return (pilot if n_big == 16 else later), {"n_small": n_small, "n_big": n_big}

    monkeypatch.setattr(prof, "fori_slope_time", lambda *a, **k: fake(*a, **k, pilot=0.1))
    assert prof.auto_slope_time(None, None)[0] == 0.1 and calls == [16, 16]
    calls.clear()
    monkeypatch.setattr(prof, "fori_slope_time",
                        lambda *a, **k: fake(*a, **k, pilot=1e-7, later=1e-9))
    t, diag = prof.auto_slope_time(None, None, target_delta_s=0.25, n_cap=10 ** 9)
    assert calls == [16, 2500000, 5000000, 10000000] and diag["n_big"] == 10000000
    per_iter, _ = auto_slope_time(lambda i, c: c * 0.5 + i.float(), torch.zeros(3),
                                  target_delta_s=0.002, reps=2)
    assert per_iter > 0.0
