"""The CUDA kernels against their plain PyTorch versions on the card.

Runs only where a CUDA card is present (marker ``cuda``; skipped with a
reason elsewhere).  On the card: ``python -m pytest tests/test_torch_kernels.py``.
Tolerances as in chip_smoke.py: chol-bundle |k-p| <= 1e-5 + 1e-4|p|
(fp32, other summation order, amplified by the factorization's
conditioning); IAF chain within 1e-4 of each transition's largest |z|;
IAF-chain backward (near-identity flows) within 1e-4 of each output's
largest entry, the forward's residual ys within 1e-4 of its scale, both at
B up to 300 (more clusters than one wave), in the instantiation with
weights in shared memory and the streamed one (NH=16, and the shipped
NH=3 forced), and bit-identical on relaunch; HMC
terms: log pi atol 1e-5 and grad within 1e-4 of its scale against the plain
version, and against fp64 no worse than 4x the plain version (or 1e-4 of
scale).  Metric bundle and G^{-1}: against the plain version at the JAX
package's kernel tolerances (G^{-1} rtol 1e-5 atol 1e-6, L and logdet 1e-4,
G 1e-3), and against fp64 each output's error at most twice the plain fp32
version's, or within 1e-5 of the output's scale.  decode+MSE: the loss
within 1e-5 relative of the plain version (and against fp64 at most twice
the plain fp32 version's error, or 1e-6 relative), dh, dW and db within
1e-3 of each one's largest entry (a bf16 rounding of dp may flip where the
fp32 pre-activation is summed in another order; dh as its fp32 sum, with
an fp32 h), the bf16 dh of a bf16 h within one bf16 step of each element
(its final rounding flips where the fp32 sum, taken in another order, lies
near a tie) plus that 1e-3, rows with rw = 0 exactly zero in dh, and every
output bit-identical from one launch to the next.  HMC partials (one shard's
gi_part and v): within 1e-5 (gi_part) and 1e-4 (v) of max(1, |plain|)
elementwise, against fp64 no worse than 4x the plain version (or 1e-5 of
scale), bit-identical on relaunch, and a bank padded with far centroids and
zero matrices bit-identical to the unpadded one.  Both HMC kernels also at
geometries other than their rule's (``hmc_*_at_f32``), replayed in a CUDA
graph bit for bit, and their rule held to ``metric_kernels.hmc_geometry``."""

import numpy as np
import pytest
import torch

from rlvae_tpu_torch.flows import TemporalFlows
from rlvae_tpu_torch.ops.iaf_kernels import (
    IAFChain,
    _launch_bwd,
    _launch_fwd,
    chain_geometry,
    launch_geometry,
    iaf_chain_bwd,
    iaf_chain_bwd_ref,
    iaf_chain_fwd,
    iaf_chain_fwd_ref,
    stack_chain,
)
from rlvae_tpu_torch.ops import hmc_sweep, metric_kernels, recon_kernels
from rlvae_tpu_torch.ops.build import kernel_library
from rlvae_tpu_torch.ops.metric_kernels import (
    chol_bundle,
    chol_bundle_ref,
    g_inv,
    g_inv_ref,
    hmc_partials,
    hmc_partials_ref,
    hmc_terms,
    hmc_terms_ref,
    metric_bundle,
    metric_bundle_ref,
)
from rlvae_tpu_torch.ops.recon_kernels import (
    DecodeMSE,
    decode_mse,
    decode_mse_bwd_dh,
    decode_mse_bwd_dw,
    decode_mse_dh_ref,
    decode_mse_dw_ref,
    decode_mse_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b", [1, 7, 64, 300])
@pytest.mark.parametrize("k", [1, 50, 200, 20_000])
def test_chol_bundle_matches_plain(dev, b, k):
    rng = np.random.default_rng(k + b)
    c = rng.normal(size=(k, 16)).astype(np.float32)
    a = (rng.normal(size=(k, 16, 16)) / 4).astype(np.float32)
    m = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(16, dtype=np.float32)
    z = c[rng.integers(0, k, size=b)] + 0.05 * rng.normal(size=(b, 16))
    args = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (z, c, m)]
    before = chol_bundle.launches
    l_k, ld_k = chol_bundle(*args, 4.0, 0.01 + 1e-6)
    l_p, ld_p = chol_bundle_ref(*args, 4.0, 0.01 + 1e-6)
    torch.cuda.synchronize()
    assert chol_bundle.launches == before + 1
    assert torch.all(torch.triu(l_k, 1) == 0)
    torch.testing.assert_close(l_k, l_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ld_k, ld_p, rtol=1e-4, atol=1e-5)


def test_chol_bundle_rejects_bad_inputs(dev):
    z = torch.zeros((4, 16), device=dev)
    c = torch.zeros((3, 16), device=dev)
    m = torch.eye(16, device=dev).expand(3, 16, 16).contiguous()
    with pytest.raises(TypeError):
        chol_bundle(z.double(), c, m, 1.0, 0.1)
    with pytest.raises(ValueError):
        chol_bundle(z[:, :8].contiguous(), c[:, :8].contiguous(), m[:, :8, :8].contiguous(), 1.0, 0.1)
    with pytest.raises(RuntimeError):
        chol_bundle(z.requires_grad_(), c, m, 1.0, 0.1)


IAF_BATCHES = [1, 7, 16, 37, 64, 300]  # 300: more clusters than one wave


@pytest.mark.parametrize("b", IAF_BATCHES)
def test_iaf_chain_matches_plain(dev, b):
    g = torch.Generator().manual_seed(b)
    flows = TemporalFlows(16, 8, 256, 2, 3, log_var_bias_init=0.0, generator=g)
    flows = flows.to(dev).requires_grad_(False)
    w = stack_chain([flows.flows[min(t, 7)] for t in range(7)])
    z0 = torch.randn(b, 16, generator=g).to(dev)
    before = iaf_chain_fwd.launches
    z_k, ld_k = iaf_chain_fwd(z0, *w)
    z_p, ld_p = iaf_chain_fwd_ref(z0, *w)
    torch.cuda.synchronize()
    assert iaf_chain_fwd.launches == before + 1
    scale = z_p.abs().flatten(1).max(1).values[:, None, None]
    assert torch.all((z_k - z_p).abs() <= 1e-4 * scale)
    torch.testing.assert_close(ld_k, ld_p, rtol=1e-4, atol=1e-4)


def _scaled_close(got, want, rtol=1e-4):
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


@pytest.mark.parametrize("b", IAF_BATCHES)
def test_iaf_chain_bwd_matches_plain(dev, b):
    g = torch.Generator().manual_seed(b)
    flows = TemporalFlows(16, 8, 256, 2, 3, log_var_bias_init=0.0, generator=g)
    flows = flows.to(dev).requires_grad_(False)
    w = stack_chain([flows.flows[min(t, 7)] for t in range(7)])
    z0 = torch.randn(b, 16, generator=g).to(dev)
    dz = torch.randn(7, b, 16, generator=g).to(dev)
    dld = torch.randn(7, b, generator=g).to(dev)
    z, ld, ys = iaf_chain_fwd(z0, *w, return_ys=True)
    _, _, ys_p = iaf_chain_fwd_ref(z0, *w, return_ys=True)
    _scaled_close(ys, ys_p)
    before = iaf_chain_bwd.launches
    dz0_k, grads_k = iaf_chain_bwd(ys, dz, dld, *w)
    dz0_p, grads_p = iaf_chain_bwd_ref(ys, dz, dld, *w)
    torch.cuda.synchronize()
    assert iaf_chain_bwd.launches == before + 1
    for got, want in zip((dz0_k, *grads_k), (dz0_p, *grads_p)):
        _scaled_close(got, want)


def _chain_problem(dev, b, nh=3, seed=0, d=16, h=256):
    g = torch.Generator().manual_seed(seed + b)
    flows = TemporalFlows(d, 8, h, 2, nh, log_var_bias_init=0.0, generator=g)
    w = stack_chain([flows.to(dev).requires_grad_(False).flows[min(t, 7)] for t in range(7)])
    z0 = torch.randn(b, d, generator=g).to(dev)
    dz = torch.randn(7, b, d, generator=g).to(dev)
    dld = torch.randn(7, b, generator=g).to(dev)
    return w, z0, dz, dld


def _hold_to_plain(w, z0, dz, dld, fwd, bwd):
    z, ld, ys = fwd(z0, w)
    z_p, ld_p, ys_p = iaf_chain_fwd_ref(z0, *w, return_ys=True)
    dz0, grads = bwd(ys_p, dz, dld, w)
    dz0_p, grads_p = iaf_chain_bwd_ref(ys_p, dz, dld, *w)
    torch.cuda.synchronize()
    scale = z_p.abs().flatten(1).max(1).values[:, None, None]
    assert torch.all((z - z_p).abs() <= 1e-4 * scale)
    torch.testing.assert_close(ld, ld_p, rtol=1e-4, atol=1e-4)
    _scaled_close(ys, ys_p)
    for got, want in zip((dz0, *grads), (dz0_p, *grads_p)):
        if want.numel():  # NH=1 has no hidden weights
            _scaled_close(got, want)


@pytest.mark.parametrize("b", [7, 64])
def test_iaf_chain_streamed_weights_match_plain(dev, b):
    """NH=16 at H=256 does not fit in shared memory: the public wrappers run
    the streamed instantiation; at the shipped NH=3 the same instantiation,
    asked for explicitly, is held to the same tolerances."""
    assert not launch_geometry(b, 16, 256, 16)["weights_resident"]
    assert not launch_geometry(b, 16, 256, 16, backward=True)["weights_resident"]
    w, z0, dz, dld = _chain_problem(dev, b, nh=16)
    _hold_to_plain(w, z0, dz, dld,
                   lambda z, ws: iaf_chain_fwd(z, *ws, return_ys=True),
                   lambda ys, dz_, dld_, ws: iaf_chain_bwd(ys, dz_, dld_, *ws))
    w, z0, dz, dld = _chain_problem(dev, b)
    assert launch_geometry(b, 16, 256, 3)["weights_resident"]
    _hold_to_plain(w, z0, dz, dld,
                   lambda z, ws: _launch_fwd(z, ws, return_ys=True, stream_weights=True),
                   lambda ys, dz_, dld_, ws: _launch_bwd(ys, dz_, dld_, ws, stream_weights=True))


@pytest.mark.parametrize("d,h,nh", [(16, 256, 1), (16, 256, 2), (16, 256, 4), (32, 256, 3),
                                    (6, 100, 3), (5, 20, 3), (2, 8, 2)])
@pytest.mark.parametrize("b", [3, 20])
def test_iaf_chain_other_shapes_match_plain(dev, b, d, h, nh):
    """Shapes off the presets: no or more hidden layers, the largest D, a
    width that leaves the last CTAs of a cluster a partial or no column
    slice, an odd D (streamed), a tiny chain; resident or streamed as the
    geometry decides, both held to the plain version."""
    w, z0, dz, dld = _chain_problem(dev, b, nh=nh, d=d, h=h)
    _hold_to_plain(w, z0, dz, dld,
                   lambda z, ws: iaf_chain_fwd(z, *ws, return_ys=True),
                   lambda ys, dz_, dld_, ws: iaf_chain_bwd(ys, dz_, dld_, *ws))


@pytest.mark.parametrize("stream_weights", [False, True])
def test_iaf_chain_relaunch_is_bit_identical(dev, stream_weights):
    """Partials are added in rank order and cluster order, never by atomics."""
    w, z0, dz, dld = _chain_problem(dev, 37)
    first = _launch_fwd(z0, w, return_ys=True, stream_weights=stream_weights)
    again = _launch_fwd(z0, w, return_ys=True, stream_weights=stream_weights)
    assert all(map(torch.equal, first, again))
    g1 = _launch_bwd(first[2], dz, dld, w, stream_weights=stream_weights)
    g2 = _launch_bwd(first[2], dz, dld, w, stream_weights=stream_weights)
    assert torch.equal(g1[0], g2[0]) and all(map(torch.equal, g1[1], g2[1]))


def test_iaf_chain_kernels_replay_in_a_cuda_graph(dev):
    """The launchers neither synchronise nor allocate: after a warm-up
    launch, both kernels capture into a CUDA graph whose replay gives the
    eager launches' bits."""
    w, z0, dz, dld = _chain_problem(dev, 16)
    eager_f = iaf_chain_fwd(z0, *w, return_ys=True)
    eager_b = iaf_chain_bwd(eager_f[2], dz, dld, *w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_f = iaf_chain_fwd(z0, *w, return_ys=True)
        out_b = iaf_chain_bwd(out_f[2], dz, dld, *w)
    graph.replay()
    torch.cuda.synchronize()
    assert all(map(torch.equal, out_f, eager_f))
    assert torch.equal(out_b[0], eager_b[0]) and all(map(torch.equal, out_b[1], eager_b[1]))


def test_geometry_matches_the_launchers(dev):
    """``chain_geometry`` (which sizes the backward's workspace) against the
    launchers' own rule, read from the library; the shipped shape keeps its
    weights in shared memory, NH=16 and an odd D stream them, and B <= 64
    runs in one wave."""
    for d, nh in ((16, 1), (16, 3), (16, 16), (15, 3)):
        for b in list(range(1, 70)) + [100, 300, 1000]:
            g = chain_geometry(b)
            for backward in (False, True):
                got = launch_geometry(b, d, 256, nh, backward=backward)
                assert (got["rows"], got["ctas"], got["clusters"]) == tuple(g), (b, nh, backward)
                assert got["weights_resident"] == int(d == 16 and nh <= 3), (b, d, nh, backward)
                assert 0 < got["smem_bytes_per_cta"] <= 227 * 1024
                assert got["max_active_clusters"] >= 1  # such clusters can be resident
                if b <= 64:
                    assert g.clusters <= got["max_active_clusters"]  # one wave


def test_iaf_chain_function_launches_both_kernels(dev):
    g = torch.Generator().manual_seed(0)
    flows = TemporalFlows(16, 8, 256, 2, 3, log_var_bias_init=0.0, generator=g).to(dev)
    z0 = torch.randn(16, 16, generator=g).to(dev).requires_grad_(True)
    fwd, bwd = iaf_chain_fwd.launches, iaf_chain_bwd.launches
    z, ld = IAFChain.apply(z0, *stack_chain([flows.flows[min(t, 7)] for t in range(7)]))
    (z.square().sum() + ld.sum()).backward()
    torch.cuda.synchronize()
    assert (iaf_chain_fwd.launches, iaf_chain_bwd.launches) == (fwd + 1, bwd + 1)
    assert torch.isfinite(z0.grad).all()
    assert all(p.grad is not None for p in flows.flows[0].parameters())


def _bank(k, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, 16)).astype(np.float32)
    a = (rng.normal(size=(k, 16, 16)) / 4).astype(np.float32)
    return c, (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(16, dtype=np.float32)).astype(np.float32)


def _hmc_err(got, want64):
    """(max |log pi err|, max |grad err| / max |grad|) against fp64."""
    lp, g = got
    lp64, g64 = want64
    return (float((lp.double() - lp64).abs().max()),
            float((g.double() - g64).abs().max() / g64.abs().max().clamp_min(1e-30)))


@pytest.mark.parametrize("b", [1, 64, 1000])
@pytest.mark.parametrize("k", [1, 50, 200, 20_000])
def test_hmc_terms_matches_plain_and_fp64(dev, b, k):
    """The kernel against its plain fp32 version (log pi atol 1e-5, grad
    1e-4 of its scale) and against an fp64 evaluation: the kernel's error
    at most 4x the plain version's, or 1e-4 of the output's scale.  The
    last rows sit far from every centroid (log pi on the log 1e-10 plateau,
    w underflows, grad 0)."""
    c, m = _bank(k, k + b)
    rng = np.random.default_rng(b)
    z = c[rng.integers(0, k, size=b)] + 0.05 * rng.normal(size=(b, 16))
    n_far = min(2, b - 1) if b > 1 else 0
    z[b - n_far:] += 100.0
    zt, ct, mt = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (z, c, m))
    args = (4.0, 0.01, float(np.log(np.float32(1e-10))))
    before = hmc_terms.launches
    got = hmc_terms(zt, ct, mt, *args)
    plain = hmc_terms_ref(zt, ct, mt, *args)
    want64 = hmc_terms_ref(zt.double(), ct.double(), mt.double(), *args)
    torch.cuda.synchronize()
    assert hmc_terms.launches == before + 1
    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=1e-5)
    _scaled_close(got[1], plain[1])
    k_lp, k_g = _hmc_err(got, want64)
    p_lp, p_g = _hmc_err(plain, want64)
    assert k_lp <= max(4 * p_lp, 1e-4 * float(want64[0].abs().max()))
    assert k_g <= max(4 * p_g, 1e-4)
    if n_far:
        assert torch.all(got[1][b - n_far:] == 0)
        torch.testing.assert_close(got[0][b - n_far:], plain[0][b - n_far:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("geometry", [(1, 16, 8), (2, 8, 4), (4, 16, 6), (8, 8, 8), (4, 3, 2),
                                      (8, 8, 1)])
def test_hmc_terms_at_other_geometries(dev, geometry):
    """B4 at a given geometry (``hmc_terms_at_f32``) against the plain version
    at B=64, K=2000, with the tolerances of the rule's launch; far rows on the
    plateau with a zero gradient; bit-identical on relaunch."""
    c, m = _bank(2000, 13)
    rng = np.random.default_rng(14)
    z = c[rng.integers(0, 2000, size=64)] + 0.05 * rng.normal(size=(64, 16))
    z[-2:] += 100.0
    zt, ct, mt = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (z, c, m))
    lib = kernel_library()
    got, again = (hmc_sweep.terms_at(lib, zt, ct, mt, geometry) for _ in range(2))
    plain = hmc_terms_ref(zt, ct, mt, hmc_sweep.INV_T2, hmc_sweep.LBD, hmc_sweep.LOG_EPS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=1e-5)
    _scaled_close(got[1], plain[1])
    assert torch.all(got[1][-2:] == 0)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_hmc_terms_padded_bank_is_bit_identical(dev):
    """37 centroids padded to 40 (far centroids, zero matrices) give B4 the
    same chunks and geometry: the padded centroids add exact zeros, so log pi
    and the gradient keep their bits."""
    c, m = _bank(37, 5)
    cp = np.concatenate([c, np.full((3, 16), 1e6, np.float32)])
    mp = np.concatenate([m, np.zeros((3, 16, 16), np.float32)])
    rng = np.random.default_rng(10)
    for b in (1, 37, 64, 1000):
        z = c[rng.integers(0, 37, size=b)] + 0.05 * rng.normal(size=(b, 16))
        zt = torch.tensor(z, dtype=torch.float32, device=dev)
        args = (1.0 / 9.0, 0.01, float(np.log(np.float32(1e-10))))
        got = hmc_terms(zt, *(torch.tensor(v, device=dev) for v in (c, m)), *args)
        padded = hmc_terms(zt, *(torch.tensor(v, device=dev) for v in (cp, mp)), *args)
        assert torch.equal(got[0], padded[0]) and torch.equal(got[1], padded[1]), b


def test_hmc_kernels_replay_in_a_cuda_graph(dev):
    """The HMC launchers neither synchronise nor allocate: after a warm-up
    launch, B4 and B8 capture into a CUDA graph, at the rule's geometry with
    one CTA a row (K=50) and with clusters (K=20 000), whose replay gives the
    eager launches' bits."""
    for k in (50, 20_000):
        c, m = _bank(k, 21)
        rng = np.random.default_rng(k)
        z = c[rng.integers(0, k, size=64)] + 0.05 * rng.normal(size=(64, 16))
        zt, ct, mt = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (z, c, m))
        args = (4.0, 0.01, float(np.log(np.float32(1e-10))))
        eager_t = hmc_terms(zt, ct, mt, *args)
        eager_p = hmc_partials(zt, ct, mt, 4.0)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out_t = hmc_terms(zt, ct, mt, *args)
            out_p = hmc_partials(zt, ct, mt, 4.0)
        graph.replay()
        torch.cuda.synchronize()
        assert all(map(torch.equal, out_t, eager_t)) and all(map(torch.equal, out_p, eager_p)), k


def test_hmc_geometry_matches_the_launchers(dev):
    """``metric_kernels.hmc_geometry`` with the card's cluster slots against
    the launchers' own rule, read from the library; a cluster never exceeds
    8 CTAs and the card holds all of a launch's clusters at once."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = metric_kernels.hmc_cluster_slots(dev)
    for k in (1, 37, 40, 50, 200, 256, 2000, 20_000):
        for b in list(range(1, 70)) + [100, 300, 1000]:
            g = metric_kernels.hmc_geometry(b, k, sms, slots)
            assert metric_kernels.launch_hmc_geometry(b, k, dev) == g, (b, k)
            assert 1 <= g.ctas <= 8 and (g.ctas == 1 or g.clusters <= slots(*g[:3])), (b, k, g)


def test_hmc_terms_rejects_bad_inputs(dev):
    z = torch.zeros((4, 16), device=dev)
    c = torch.zeros((3, 16), device=dev)
    m = torch.eye(16, device=dev).expand(3, 16, 16).contiguous()
    with pytest.raises(TypeError):
        hmc_terms(z.double(), c, m, 1.0, 0.01, -23.0)
    with pytest.raises(ValueError):
        hmc_terms(z, c[:0], m[:0], 1.0, 0.01, -23.0)
    with pytest.raises(RuntimeError):
        hmc_terms(z.requires_grad_(), c, m, 1.0, 0.01, -23.0)


def test_logdet_g_inv_gradient_on_the_card_equals_the_cpu(dev):
    """logdet G^{-1} differentiates on the card (one chol-bundle launch
    forward, the plain recompute backward) and matches the CPU's gradient."""
    from rlvae_tpu_torch.geometry import metric as gm
    from rlvae_tpu_torch.geometry.metric import CentroidMetric

    c, m = _bank(50, 3)
    metric = CentroidMetric.create(c, m, temperature=0.5, regularization=0.01)
    grads = []
    for device in ("cpu", dev):
        mt = CentroidMetric(metric.centroids.to(device), metric.matrices.to(device),
                            metric.temperature, metric.regularization)
        zz = torch.tensor(c[:7] + 0.05, dtype=torch.float32, device=device, requires_grad=True)
        before = chol_bundle.launches
        gm.logdet_g_inv(mt, zz).sum().backward()
        assert chol_bundle.launches == before + (1 if zz.is_cuda else 0)
        grads.append(zz.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=1e-5 * grads[0].abs().max())


def test_sharded_g_inv_and_terms_gradient_launch_their_kernels(dev):
    """On CUDA tensors ``g_inv_sharded`` (1 x 1 mesh) launches the G^{-1}
    kernel and ``grad_log_sqrt_det_g_inv`` the HMC-terms kernel: each equals
    its kernel's own output, and G^{-1} the dense ``g_inv``."""
    from rlvae_tpu_torch.geometry import metric as gm
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.parallel import create_mesh, g_inv_sharded, shard_metric

    c, m = _bank(50, 4)
    metric = CentroidMetric.create(c, m, temperature=0.5, regularization=0.01)
    mt = CentroidMetric(metric.centroids.to(dev), metric.matrices.to(dev),
                        metric.temperature, metric.regularization)
    z = torch.tensor(c[:9] + 0.05, dtype=torch.float32, device=dev)
    mesh = create_mesh()
    before = g_inv.launches
    got = g_inv_sharded(mesh, shard_metric(mesh, mt), z)
    assert g_inv.launches == before + 1
    torch.testing.assert_close(got, gm.g_inv(mt, z), rtol=1e-5, atol=1e-6)
    before = hmc_terms.launches
    grad = gm.grad_log_sqrt_det_g_inv(mt, z)
    assert hmc_terms.launches == before + 1
    want = hmc_terms(z, mt.centroids, mt.matrices, 1.0 / mt.temperature ** 2,
                     mt.regularization, float(np.log(np.float32(1e-10))))[1]
    assert torch.equal(grad, want)


def test_sharded_g_inv_of_another_dim_raises_on_the_card(dev):
    """The kernels take D=16; a D=8 bank raises on CUDA tensors (and runs on
    the CPU, ``tests/test_torch_metric_parallel.py``), never falling back."""
    from rlvae_tpu_torch.geometry import metric as gm
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.parallel import create_mesh, g_inv_sharded, shard_metric

    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 8, 8)).astype(np.float32) * 0.3
    m = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(8, dtype=np.float32)
    metric = CentroidMetric.create(rng.normal(size=(6, 8)).astype(np.float32), m, 0.9, 0.01)
    mt = CentroidMetric(metric.centroids.to(dev), metric.matrices.to(dev),
                        metric.temperature, metric.regularization)
    z = torch.zeros((3, 8), device=dev)
    mesh = create_mesh()
    before = (g_inv.launches, hmc_terms.launches)
    with pytest.raises(ValueError):
        g_inv_sharded(mesh, shard_metric(mesh, mt), z)
    with pytest.raises(ValueError):
        gm.grad_log_sqrt_det_g_inv(mt, z)
    assert (g_inv.launches, hmc_terms.launches) == before


BUNDLE_TOL = ((1e-5, 1e-6), (1e-4, 1e-4), (1e-4, 1e-4), (1e-3, 1e-3))  # G^-1, L, logdet, G


@pytest.mark.parametrize("b,k,n_splits", [
    *((b, k, None) for k in (1, 50, 200, 20_000) for b in (1, 64, 1000)),
    # the bank summed in 1, 2, 7 or 40 ranges (the default at K=20 000 and
    # B=64 on an H100 is 17), each range in its own block
    *((64, 20_000, n) for n in (1, 2, 7, 40)), (5, 200, 3),
])
def test_metric_bundle_and_g_inv_match_plain_and_fp64(dev, monkeypatch, b, k, n_splits):
    """Both kernels against their plain fp32 versions and an fp64 evaluation;
    the last rows of a batch lie far from every centroid (G^{-1} = lbd I).
    A given ``n_splits`` replaces the wrappers' own choice of ranges."""
    if n_splits is not None:
        monkeypatch.setattr(metric_kernels, "k_splits", lambda b, k, device: n_splits)
    c, m = _bank(k, 7 * k + b)
    rng = np.random.default_rng(b + 1)
    z = c[rng.integers(0, k, size=b)] + 0.05 * rng.normal(size=(b, 16))
    if b > 1:
        z[-2:] += 100.0
    zt, ct, mt = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (z, c, m))
    before = (metric_bundle.launches, g_inv.launches)
    got = metric_bundle(zt, ct, mt, 4.0, 0.01)
    gi_k = g_inv(zt, ct, mt, 4.0, 0.01)
    plain = metric_bundle_ref(zt, ct, mt, 4.0, 0.01)
    want64 = metric_bundle_ref(zt.double(), ct.double(), mt.double(), 4.0, 0.01)
    torch.cuda.synchronize()
    assert (metric_bundle.launches, g_inv.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(gi_k, got[0])  # the same front half
    torch.testing.assert_close(gi_k, g_inv_ref(zt, ct, mt, 4.0, 0.01), rtol=1e-5, atol=1e-6)
    for out, p, e, (rtol, atol) in zip(got, plain, want64, BUNDLE_TOL):
        torch.testing.assert_close(out, p, rtol=rtol, atol=atol)
        err_k = float((out.double() - e).abs().max())
        err_p = float((p.double() - e).abs().max())
        assert err_k <= max(2 * err_p, 1e-5 * float(e.abs().max())), (err_k, err_p)
    l, g = got[1], got[3]
    assert torch.all(torch.triu(l, 1) == 0)
    assert torch.equal(g, g.transpose(-1, -2))
    if b > 1:
        eye = torch.eye(16, device=dev)
        torch.testing.assert_close(got[0][-2:], 0.01 * eye.expand(2, 16, 16), rtol=0, atol=0)


def test_metric_bundle_rejects_bad_inputs(dev):
    z = torch.zeros((4, 16), device=dev)
    c = torch.zeros((3, 16), device=dev)
    m = torch.eye(16, device=dev).expand(3, 16, 16).contiguous()
    for wrapper in (metric_bundle, g_inv):
        with pytest.raises(TypeError):
            wrapper(z.double(), c, m, 1.0, 0.01)
        with pytest.raises(ValueError):
            wrapper(z, c[:0], m[:0], 1.0, 0.01)
        with pytest.raises(ValueError):
            wrapper(z.t(), c, m, 1.0, 0.01)
        with pytest.raises(RuntimeError):
            wrapper(z.clone().requires_grad_(), c, m, 1.0, 0.01)


@pytest.mark.parametrize("which", ["g", "g_inv"])
def test_g_and_g_inv_gradients_on_the_card_equal_the_cpu(dev, which):
    """G and G^{-1} differentiate on the card (one kernel launch forward, the
    plain recompute backward) and match the CPU's gradient."""
    from rlvae_tpu_torch.geometry import metric as gm
    from rlvae_tpu_torch.geometry.metric import CentroidMetric

    c, m = _bank(200, 4)
    metric = CentroidMetric.create(c, m, temperature=0.7, regularization=0.01)
    w = torch.randn(7, 16, 16, generator=torch.Generator().manual_seed(1))
    fn, counter = {"g": (gm.g, metric_bundle), "g_inv": (gm.g_inv, g_inv)}[which]
    grads = []
    for device in ("cpu", dev):
        mt = CentroidMetric(metric.centroids.to(device), metric.matrices.to(device),
                            metric.temperature, metric.regularization)
        zz = torch.tensor(c[:7] + 0.05, dtype=torch.float32, device=device, requires_grad=True)
        before = counter.launches
        (fn(mt, zz) * w.to(device)).sum().backward()
        assert counter.launches == before + (1 if zz.is_cuda else 0)
        grads.append(zz.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=1e-5 * grads[0].abs().max())


@pytest.mark.parametrize("b,k,geometry", [
    *((b, k, None) for k in (1, 37, 50, 200, 20_000) for b in (1, 37, 64)),
    # a given geometry (rows per CTA, warps per CTA, CTAs per cluster) in place
    # of the rule's: rows unblocked, blocked 4 and 8; clusters of 8, 6, 3 and 1
    *((64, 20_000, g) for g in ((1, 16, 8), (4, 16, 6), (8, 8, 8), (2, 4, 3))),
    (5, 200, (2, 8, 2)), (37, 2000, (4, 16, 5)),
])
def test_hmc_partials_matches_plain_and_fp64(dev, b, k, geometry):
    """The kernel against its plain fp32 version and an fp64 evaluation, and
    against itself on relaunch; the last rows of a batch lie far from every
    centroid (every weight underflows: gi_part and v exactly 0).  A given
    ``geometry`` launches ``hmc_partials_at_f32`` in place of the wrapper's
    rule."""
    c, m = _bank(k, 11 * k + b)
    rng = np.random.default_rng(b + 2)
    z = c[rng.integers(0, k, size=b)] + 0.05 * rng.normal(size=(b, 16))
    if b > 1:
        z[-2:] += 100.0
    zt, ct, mt = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (z, c, m))
    before = hmc_partials.launches
    if geometry is None:
        got = hmc_partials(zt, ct, mt, 4.0)
        again = hmc_partials(zt, ct, mt, 4.0)
        assert hmc_partials.launches == before + 2
    else:
        lib = kernel_library()
        got, again = (hmc_sweep.partials_at(lib, zt, ct, mt, geometry) for _ in range(2))
    plain = hmc_partials_ref(zt, ct, mt, 4.0)
    want64 = hmc_partials_ref(zt.double(), ct.double(), mt.double(), 4.0)
    torch.cuda.synchronize()
    assert got[0].shape == (b, 16, 16) and got[1].shape == (b, 16)
    for out, rerun, p, e, tol in zip(got, again, plain, want64, (1e-5, 1e-4)):
        assert torch.equal(out, rerun)
        assert bool(torch.all((out - p).abs() <= tol * p.abs().clamp_min(1.0)))
        err_k = float((out.double() - e).abs().max())
        err_p = float((p.double() - e).abs().max())
        assert err_k <= max(4 * err_p, 1e-5 * float(e.abs().max())), (err_k, err_p)
    if b > 1:
        assert torch.all(got[0][-2:] == 0) and torch.all(got[1][-2:] == 0)


def test_hmc_partials_padded_bank_is_bit_identical(dev):
    """37 centroids padded to 40 with far centroids (1e6) and zero matrices,
    as the centroid-sharded path pads them: w = 0 exactly, so each padded
    centroid adds exact zeros to both sums."""
    c, m = _bank(37, 5)
    cp = np.concatenate([c, np.full((3, 16), 1e6, np.float32)])
    mp = np.concatenate([m, np.zeros((3, 16, 16), np.float32)])
    rng = np.random.default_rng(9)
    z = c[rng.integers(0, 37, size=64)] + 0.05 * rng.normal(size=(64, 16))
    zt = torch.tensor(z, dtype=torch.float32, device=dev)
    got = hmc_partials(zt, *(torch.tensor(v, device=dev) for v in (c, m)), 1.0 / 9.0)
    padded = hmc_partials(zt, *(torch.tensor(v, device=dev) for v in (cp, mp)), 1.0 / 9.0)
    assert torch.equal(got[0], padded[0]) and torch.equal(got[1], padded[1])


def test_hmc_partials_rejects_bad_inputs(dev):
    z = torch.zeros((4, 16), device=dev)
    c = torch.zeros((3, 16), device=dev)
    m = torch.eye(16, device=dev).expand(3, 16, 16).contiguous()
    with pytest.raises(TypeError):
        hmc_partials(z.double(), c, m, 1.0)
    with pytest.raises(ValueError):
        hmc_partials(z, c[:0], m[:0], 1.0)
    with pytest.raises(ValueError):
        hmc_partials(z.t(), c, m, 1.0)
    with pytest.raises(RuntimeError):
        hmc_partials(z.clone().requires_grad_(), c, m, 1.0)


def _decode_problem(dev, m, n, k=512, seed=0):
    """Decoder-like inputs: h post-ReLU bf16, W [N, K] and b at the scale of a
    Linear init, targets in [0, 1], row weights 1/B with rows 3 and 4 at 0."""
    rng = np.random.default_rng(seed + m + n)
    h = np.maximum(rng.normal(size=(m, k)), 0.0)
    w = rng.uniform(-1, 1, size=(n, k)) / np.sqrt(k)
    b = rng.uniform(-1, 1, size=(n,)) / np.sqrt(k)
    x = rng.uniform(size=(m, n))
    rw = np.full((m,), 1.0 / 16)
    rw[3:5] = 0.0
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return t(h).to(torch.bfloat16), t(w), t(b), t(x), t(rw)


def _within_scale(got, want, rtol=1e-3):
    got, want = got.float(), want.float()
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


def _within_a_bf16_step(got, want, rtol=1e-3):
    """|got - want| <= 2^-7 |want| + rtol * max |want|: one bf16 step of each
    element (7 stored mantissa bits) on top of the fp32 tolerance."""
    got, want = got.float(), want.float()
    limit = 2.0 ** -7 * want.abs() + rtol * float(want.abs().max())
    assert bool(torch.all((got - want).abs() <= limit))


def _hold_decode_to_plain(dev, m, n, k):
    h, w, b, x, rw = _decode_problem(dev, m, n, k)
    g = torch.tensor(1.0, device=dev)
    counts = (decode_mse.launches, decode_mse_bwd_dh.launches, decode_mse_bwd_dw.launches)
    loss = decode_mse(h, w, b, x, rw)
    dh = decode_mse_bwd_dh(h, w, b, x, rw, g)
    dw, db = decode_mse_bwd_dw(h, w, b, x, rw, g)
    torch.cuda.synchronize()
    assert (decode_mse.launches, decode_mse_bwd_dh.launches,
            decode_mse_bwd_dw.launches) == tuple(c + 1 for c in counts)
    ref = decode_mse_ref(h, w, b, x, rw)
    ref64 = decode_mse_ref(h, w.double(), b.double(), x.double(), rw.double())
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref)) + 1e-30
    err_k, err_p = abs(float(loss) - float(ref64)), abs(float(ref) - float(ref64))
    assert err_k <= max(2 * err_p, 1e-6 * abs(float(ref64)))
    assert dh.dtype == torch.bfloat16 and dh.shape == (m, k)
    _within_a_bf16_step(dh, decode_mse_dh_ref(h, w, b, x, rw, g))
    dh32 = decode_mse_bwd_dh(h.float(), w, b, x, rw, g)
    assert dh32.dtype == torch.float32
    _within_scale(dh32, decode_mse_dh_ref(h.float(), w, b, x, rw, g))
    dw_p, db_p = decode_mse_dw_ref(h, w, b, x, rw, g)
    _within_scale(dw, dw_p)
    _within_scale(db, db_p)
    if m > 4:
        assert torch.all(dh[3:5] == 0)
    # bit-identical from run to run (no atomics, fixed summation orders)
    assert torch.equal(loss, decode_mse(h, w, b, x, rw))
    assert torch.equal(dh, decode_mse_bwd_dh(h, w, b, x, rw, g))
    assert all(torch.equal(a, c) for a, c in zip((dw, db), decode_mse_bwd_dw(h, w, b, x, rw, g)))


@pytest.mark.parametrize("m,n,k", [(128, 12288, 512), (37, 300, 512), (512, 12288, 512),
                                   (37, 300, 64), (1, 1, 1)])
def test_decode_mse_matches_plain_and_fp64(dev, m, n, k):
    _hold_decode_to_plain(dev, m, n, k)


@pytest.mark.parametrize("k", [1, 16, 64, 500, 512])
@pytest.mark.parametrize("m", [1, 37, 128, 129, 512, 1000])
def test_decode_mse_tiling_edges(dev, m, k):
    """Shapes that cross the kernels' tiles: one row, ragged 64- and 32-row
    tiles, K not a multiple of 8 or 64 (zero-padded in shared memory), and a
    ragged N of 777 (98 blocks of 8, the last cut)."""
    _hold_decode_to_plain(dev, m, 777, k)


@pytest.mark.parametrize("m", [129, 1000])
def test_decode_mse_tiling_edges_at_full_width(dev, m):
    """N = 12290: one column past the fast preset's, so the last CTA's range
    ends inside an 8-column block; K = 500."""
    _hold_decode_to_plain(dev, m, 12290, 500)


@pytest.mark.parametrize("cluster", list(range(1, 9)) + ["spread"])
def test_decode_mse_dh_any_split_of_the_columns(dev, monkeypatch, cluster):
    """dh sums its CTAs' column shares in rank order inside a cluster and the
    clusters' partials in a second pass; every cluster size the rule can
    choose (1 to 8, with the fewest clusters that cover N), and a spread of
    more clusters than needed with two row groups, give the plain version's
    dh (the split only moves fp32 rounding)."""
    h, w, b, x, rw = _decode_problem(dev, 128, 12288)
    g = torch.tensor(0.5, device=dev)
    rule = recon_kernels.launch_decode_geometry(128, 12288, 512, dev)
    need = -(-(12288 // 8) // recon_kernels.DH_BLOCKS)
    if cluster == "spread":
        geo = rule._replace(dh_cluster=2, dh_clusters=need, dh_row_groups=2)
    else:
        geo = rule._replace(dh_cluster=cluster, dh_clusters=-(-need // cluster), dh_row_groups=1)
    monkeypatch.setattr(recon_kernels, "launch_decode_geometry", lambda m, n, k, device: geo)
    dh = decode_mse_bwd_dh(h.float(), w, b, x, rw, g)
    torch.cuda.synchronize()
    _within_scale(dh, decode_mse_dh_ref(h.float(), w, b, x, rw, g))
    assert torch.all(dh[3:5] == 0)


@pytest.mark.parametrize("m,n", [(128, 12288), (37, 300)])
def test_decode_mse_replays_in_a_cuda_graph(dev, m, n):
    """The three launchers neither synchronise nor allocate: after a warm-up
    launch, they capture into a CUDA graph whose replay gives the eager
    launches' bits, with clusters summing through a workspace (N = 12288)
    and with one cluster writing dh itself (N = 300)."""
    h, w, b, x, rw = _decode_problem(dev, m, n)
    g = torch.tensor(1.0, device=dev)

    def launch():
        return (decode_mse(h, w, b, x, rw), decode_mse_bwd_dh(h, w, b, x, rw, g),
                *decode_mse_bwd_dw(h, w, b, x, rw, g))

    eager = launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launch()
    graph.replay()
    torch.cuda.synchronize()
    assert all(map(torch.equal, captured, eager))


def test_decode_mse_function_on_the_card_equals_the_cpu(dev):
    """DecodeMSE forward and backward on the card against the same Function
    on the CPU (the plain versions), with fp32 h (dh not rounded)."""
    h, w, b, x, rw = _decode_problem(dev, 40, 300, 64)
    outs = []
    for d in (dev, torch.device("cpu")):
        leaves = [t.detach().to(d).float().requires_grad_(True) for t in (h, w, b)]
        loss = DecodeMSE.apply(*leaves, x.to(d), rw.to(d))
        (3.0 * loss).backward()
        outs.append([loss.detach().cpu()] + [t.grad.cpu() for t in leaves])
    (lk, *gk), (lp, *gp) = outs
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, c in zip(gk, gp):
        _within_scale(a, c)


def test_decode_mse_rejects_bad_inputs(dev):
    h, w, b, x, rw = _decode_problem(dev, 8, 16, 32)
    with pytest.raises(TypeError):
        decode_mse(h, w.double(), b, x, rw)
    with pytest.raises(ValueError):
        decode_mse(h, w[:, :16].contiguous(), b, x, rw)
    with pytest.raises(ValueError):  # wider than the kernel's 512 hidden units
        hw = torch.zeros((8, 600), dtype=torch.bfloat16, device=dev)
        decode_mse(hw, torch.zeros((16, 600), device=dev), b, x, rw)
    with pytest.raises(RuntimeError):
        decode_mse(h, w.requires_grad_(True), b, x, rw)
