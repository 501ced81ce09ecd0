"""The port's flow zoo (``rlvae_tpu_torch/flows/zoo.py``, ``batchnorm.py``,
``pixelcnn.py``) against the JAX package's on the CPU.

Parameters are drawn by JAX and carried across by the converters of
``rlvae_tpu_torch/convert.py``; inputs come from seeded numpy.  Tolerances:
the flows and the BatchNorm at 1e-5 (relative to max(1, |x|)), PixelCNN's
logits and loss at 1e-5 of their scale; samples on JAX's own Gumbel draws,
equal but for steps whose two best scores lie within TIE_MARGIN (counted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlvae_tpu.flows import batchnorm as jbn
from rlvae_tpu.flows import iaf_masks
from rlvae_tpu.flows import zoo as jzoo
from rlvae_tpu.flows.pixelcnn import PixelCNN as JPixelCNN
from rlvae_tpu.flows.pixelcnn import pixelcnn_sample as j_pixelcnn_sample
from rlvae_tpu_torch import convert
from rlvae_tpu_torch.flows import batchnorm as tbn
from rlvae_tpu_torch.flows import zoo as tzoo
from rlvae_tpu_torch.flows.iaf import IAF
from rlvae_tpu_torch.flows.pixelcnn import PixelCNN, conv_mask, pixelcnn_sample

D, H = 8, 32
TOL = 1e-5
TIE_MARGIN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The torch work on one thread (the test suite runs six worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got.detach() if torch.is_tensor(got) else got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))
    assert err <= tol, err


def _x(seed, shape=(6, D)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _maf_pair(seed=0):
    params = jzoo.init_maf(jax.random.PRNGKey(seed), D, H, n_blocks=2)
    maf = tzoo.MAF(D, H, 2)
    maf.load_state_dict(convert.zoo_params_from_jax("maf", jax.device_get(params)))
    return params, maf


def test_maf_matches_jax_both_directions():
    params, maf = _maf_pair()
    masks = iaf_masks(D, H, 3)
    x = _x(1)
    y_j, ld_j = jzoo.maf_forward(params, masks, jnp.asarray(x))
    with torch.no_grad():
        y_t, ld_t = tzoo.maf_forward(maf, torch.from_numpy(x))
        _close(y_t, y_j)
        _close(ld_t, ld_j)
        x_j, ldi_j = jzoo.maf_inverse(params, masks, y_j)
        x_t, ldi_t = tzoo.maf_inverse(maf, torch.from_numpy(np.asarray(y_j)))
    _close(x_t, x_j)
    _close(ldi_t, ldi_j)
    _close(x_t, x, 1e-4)  # the round trip
    _close(ld_t + ldi_t, np.zeros(6), 1e-4)


def test_planar_and_radial_match_jax():
    x = _x(2)
    planar = jax.tree_util.tree_map(lambda a: a * 30.0, jzoo.init_planar(jax.random.PRNGKey(2), D))
    radial = {**jzoo.init_radial(jax.random.PRNGKey(4), D), "beta_raw": jnp.asarray(1.5),
              "log_alpha": jnp.asarray(-0.5)}
    for family, params, j_fn, t_fn in (("planar", planar, jzoo.planar_forward,
                                        tzoo.planar_forward),
                                       ("radial", radial, jzoo.radial_forward,
                                        tzoo.radial_forward)):
        y_j, ld_j = j_fn(params, jnp.asarray(x))
        y_t, ld_t = t_fn(convert.zoo_params_from_jax(family, jax.device_get(params)),
                         torch.from_numpy(x))
        _close(y_t, y_j)
        _close(ld_t, ld_j)


def test_flow_batchnorm_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(16, D)) * 2 + 1).astype(np.float32)
    params = {"log_gamma": rng.normal(size=D).astype(np.float32) * 0.3,
              "beta": rng.normal(size=D).astype(np.float32)}
    state = {"running_mean": rng.normal(size=D).astype(np.float32),
             "running_var": rng.uniform(0.5, 2.0, size=D).astype(np.float32)}
    tp, ts = convert.flow_batchnorm_from_jax(params, state)
    jp, js = jax.tree_util.tree_map(jnp.asarray, (params, state))
    for train in (True, False):
        y_j, ld_j, ns_j = jbn.batchnorm_forward(jp, js, jnp.asarray(x), train=train)
        y_t, ld_t, ns_t = tbn.batchnorm_forward(tp, ts, torch.from_numpy(x), train=train)
        _close(y_t, y_j)
        _close(ld_t, ld_j)
        assert ld_t.shape == (16,)
        assert sorted(ns_t) == sorted(ns_j)
        for k in ns_j:
            _close(ns_t[k], ns_j[k])
        # the inverse: the batch statistics in train, the running ones in eval
        for inv_train in (True, False):
            x_j, ldi_j = jbn.batchnorm_inverse(jp, ns_j, y_j, train=inv_train)
            x_t, ldi_t = tbn.batchnorm_inverse(tp, ns_t, torch.from_numpy(np.asarray(y_j)),
                                               train=inv_train)
            _close(x_t, x_j)
            _close(ldi_t, ldi_j)
    p0, s0 = tbn.init_batchnorm(D)
    jp0, js0 = jbn.init_batchnorm(D)
    for got, want in ((p0, jp0), (s0, js0)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("family", jzoo.NormalizingFlow.FAMILIES)
def test_normalizing_flow_loads_jax_saves(family, tmp_path):
    """A directory saved by JAX's ``NormalizingFlow.save`` loads in the port
    and gives JAX's outputs; the port's save loads back in both packages."""
    x = _x(5)
    nf_j = jzoo.NormalizingFlow(family, D, key=jax.random.PRNGKey(1), hidden_size=16)
    if family == "planar":
        nf_j.params = jax.tree_util.tree_map(lambda a: a * 30.0, nf_j.params)
    nf_j.save(tmp_path / "jax")
    nf_t = tzoo.NormalizingFlow.load(tmp_path / "jax", device="cpu")
    assert tzoo.flow_param_count(nf_t.params) == jzoo.flow_param_count(nf_j.params)
    y_j, ld_j = nf_j.forward(x)
    with torch.no_grad():
        y_t, ld_t = nf_t.forward(x)
    _close(y_t, y_j)
    _close(ld_t, ld_j)
    if family in ("iaf", "maf"):
        x_j, ldi_j = nf_j.inverse(np.asarray(y_j))
        with torch.no_grad():
            x_t, ldi_t = nf_t.inverse(np.asarray(y_j))
        _close(x_t, x_j)
        _close(ldi_t, ldi_j)
    else:
        with pytest.raises(NotImplementedError):
            nf_t.inverse(y_t)
    nf_t.save(tmp_path / "port")
    back_j = jzoo.NormalizingFlow.load(tmp_path / "port")
    back_t = tzoo.NormalizingFlow.load(tmp_path / "port", device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(back_t.forward(x)[0].numpy(), y_t.numpy())
    _close(back_j.forward(x)[0], y_j)


def test_zoo_converters_and_inits():
    params = jzoo.init_maf(jax.random.PRNGKey(0), D, H)
    iaf = IAF(D, H, 2)
    iaf.load_state_dict(convert.zoo_params_from_jax("iaf", jax.device_get(params)))
    assert tzoo.flow_param_count(iaf) == jzoo.flow_param_count(params)
    gen = torch.Generator().manual_seed(0)
    for family, init in (("planar", tzoo.init_planar), ("radial", tzoo.init_radial)):
        ours = init(D, gen)
        theirs = (jzoo.init_planar if family == "planar" else jzoo.init_radial)(
            jax.random.PRNGKey(0), D)
        assert {k: tuple(v.shape) for k, v in ours.items()} == {
            k: tuple(v.shape) for k, v in theirs.items()}
    with pytest.raises(ValueError):
        convert.zoo_params_from_jax("glow", {})


# ---------------------------------------------------------------------------
# PixelCNN
# ---------------------------------------------------------------------------

PCNN = {"input_dim": (1, 6, 6), "n_embeddings": 16, "n_layers": 3, "kernel_size": 3,
        "hidden": 8}


def _pixelcnn_variables():
    """Flax variables drawn with numpy in the tree ``PixelCNN.init`` gives
    (its eager init costs seconds); batch statistics away from (0, 1)."""
    rng = np.random.default_rng(0)
    c, k, h, e = PCNN["input_dim"][0], PCNN["kernel_size"], PCNN["hidden"], PCNN["n_embeddings"]
    f32 = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)  # noqa: E731
    params, stats = {}, {}
    for i in range(PCNN["n_layers"]):
        cin = c if i == 0 else h
        params[f"MaskedConv_{i}"] = {"Conv_0": {"kernel": f32(k, k, cin, h, s=(k * k * cin) ** -0.5),
                                                "bias": f32(h, s=0.1)}}
        params[f"BatchNorm_{i}"] = {"scale": 1.0 + f32(h, s=0.1), "bias": f32(h, s=0.1)}
        stats[f"BatchNorm_{i}"] = {"mean": f32(h, s=0.3),
                                   "var": rng.uniform(0.5, 2.0, size=h).astype(np.float32)}
    params["Conv_0"] = {"kernel": f32(1, 1, h, e * c, s=h ** -0.5), "bias": f32(e * c, s=0.1)}
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def pixelcnn_pair():
    """(JAX model, its variables, the port's model carried from them)."""
    variables = _pixelcnn_variables()
    tm = PixelCNN(**PCNN)
    tm.load_state_dict(convert.pixelcnn_state_from_flax(variables))
    return JPixelCNN(**PCNN), variables, tm


def test_pixelcnn_variables_have_init_s_tree():
    """The variables' names and shapes are ``PixelCNN.init``'s (by
    ``jax.eval_shape``, which traces without computing)."""
    shapes = jax.eval_shape(JPixelCNN(**PCNN).init, jax.random.PRNGKey(0),
                            jnp.zeros((2, *PCNN["input_dim"]), jnp.int32))
    as_shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert as_shapes(_pixelcnn_variables()) == as_shapes(jax.device_get(shapes))


def test_conv_mask_matches_jax():
    from rlvae_tpu.flows.pixelcnn import conv_mask as j_conv_mask

    for kind in ("A", "B"):
        np.testing.assert_array_equal(conv_mask(5, 3, 4, kind), j_conv_mask(5, 3, 4, kind))


@pytest.mark.parametrize("train", [False, True])
def test_pixelcnn_forward_matches_flax(pixelcnn_pair, train):
    jm, variables, tm = pixelcnn_pair
    x = np.random.default_rng(1).integers(0, 16, size=(4, *PCNN["input_dim"])).astype(np.int32)
    if train:
        out_j, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        out_j = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out_t = tm(torch.from_numpy(x), train=train)
    assert out_t.out.shape == (4, 16, 1, 6, 6)
    scale = max(1.0, float(np.abs(np.asarray(out_j.out)).max()))
    assert np.abs(out_t.out.numpy() - np.asarray(out_j.out)).max() <= TOL * scale
    _close(out_t.loss, out_j.loss)
    if train:  # the running statistics moved as Flax's; put back for the other tests
        for name, stats in upd["batch_stats"].items():
            norm = tm.norms[int(name.split("_")[1])]
            _close(norm.mean, stats["mean"])
            _close(norm.var, stats["var"])
            norm.mean.copy_(torch.from_numpy(variables["batch_stats"][name]["mean"]))
            norm.var.copy_(torch.from_numpy(variables["batch_stats"][name]["var"]))


def test_pixelcnn_sample_on_jax_gumbel_draws(pixelcnn_pair):
    """JAX's sample and the port's on JAX's own Gumbel draws (one
    ``split`` per step of the raster scan), ties counted: at each step the
    port's scores, from JAX's final image (the masks make step t's logits
    depend only on the pixels before it), pick JAX's value unless the two
    best lie within TIE_MARGIN."""
    jm, variables, tm = pixelcnn_pair
    n, key = 3, jax.random.PRNGKey(7)
    x_j = np.asarray(j_pixelcnn_sample(jm, variables, key, n))
    steps = int(np.prod(PCNN["input_dim"]))
    draws, k = [], key
    for _ in range(steps):
        k, sub = jax.random.split(k)
        draws.append(np.asarray(jax.random.gumbel(sub, (n, PCNN["n_embeddings"]))))
    noise = torch.from_numpy(np.stack(draws))
    with torch.no_grad():
        logits = tm(torch.from_numpy(x_j), train=False).out.numpy()  # [n, E, 1, 6, 6]
    ties, w = 0, PCNN["input_dim"][2]
    for idx in range(steps):
        i, j = divmod(idx, w)
        scores = logits[:, :, 0, i, j] + draws[idx]
        chosen = x_j[:, 0, i, j]
        best = scores.max(-1)
        gap = best - scores[np.arange(n), chosen]
        assert (gap <= TIE_MARGIN).all(), (idx, gap)
        ties += int(((gap > 0) | (np.sort(scores, -1)[:, -2] >= best - TIE_MARGIN)).sum())
    x_t = pixelcnn_sample(tm, n, noise=noise).numpy()
    assert x_t.dtype == np.int32 and x_t.shape == x_j.shape
    if ties == 0:
        np.testing.assert_array_equal(x_t, x_j)
    with pytest.raises(ValueError):
        pixelcnn_sample(tm, n, noise=noise[:-1])
    gen = torch.Generator().manual_seed(0)
    drawn = pixelcnn_sample(tm, 2, generator=gen).numpy()
    assert drawn.shape == (2, *PCNN["input_dim"]) and drawn.min() >= 0 and drawn.max() < 16
