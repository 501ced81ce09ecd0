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
NH=3 forced), and bit-identical on relaunch; the same tolerances for the
Jacobi mode (fp_iters K = 2, 8, 15, backward at K + 1 sweeps), which at
K = D - 1 also agrees with the sequential kernel within them; the
backward's sequential mode (n_sweeps = 0) within 1e-4 of scale of its plain
version (near-identity flows), against fp64 at the reference init no worse
than 4x the plain version (or 1e-4 of scale), equal to the adjoint mode
after the masks, bit-identical on relaunch and in a CUDA-graph replay; HMC
terms: log pi atol 1e-5 and grad within 1e-4 of its scale against the plain
version, and against fp64 no worse than 4x the plain version (or 1e-4 of
scale).  Metric bundle and G^{-1}: against the plain version at the JAX
package's kernel tolerances (G^{-1} rtol 1e-5 atol 1e-6, L and logdet 1e-4,
G 1e-3), and against fp64 each output's error at most twice the plain fp32
version's, or within 1e-5 of the output's scale, at the rule's geometry and
at forced ones (``*_at_f32``); the chol-bundle, metric bundle and G^{-1}
replayed in a CUDA graph bit for bit, their rule held to
``metric_kernels.hmc_geometry`` per kernel, and G^{-1} taking views of a
sharded bank.  decode+MSE: the loss
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


@pytest.mark.parametrize("b", [1, 7, 16, 64, 300])
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
    with pytest.raises(ValueError):  # a bank neither D nor D's compiled width wide
        chol_bundle(z[:, :8].contiguous(), c[:, :12].contiguous(), m[:, :12, :12].contiguous(),
                    1.0, 0.1)
    z48, c48 = torch.zeros((4, 48), device=dev), torch.zeros((3, 48), device=dev)
    with pytest.raises(ValueError):  # past the kernels' D <= 32: the sites route, not the wrapper
        chol_bundle(z48, c48, torch.eye(48, device=dev).expand(3, 48, 48).contiguous(), 1.0, 0.1)
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


# the Jacobi mode (fp_iters = K): the kernel at K and its backward at K + 1
# sweeps against the plain versions, in both instantiations
JACOBI_ITERS = [2, 8, 15]  # 15 = D - 1: exact


@pytest.mark.parametrize("k", JACOBI_ITERS)
@pytest.mark.parametrize("b", [1, 7, 16, 64, 300])
@pytest.mark.parametrize("stream_weights", [False, True])
def test_iaf_chain_jacobi_matches_plain(dev, b, k, stream_weights):
    w, z0, dz, dld = _chain_problem(dev, b)
    before = iaf_chain_fwd.launches, iaf_chain_bwd.launches
    z, ld, ys = _launch_fwd(z0, w, return_ys=True, stream_weights=stream_weights, fp_iters=k)
    z_p, ld_p, ys_p = iaf_chain_fwd_ref(z0, *w, return_ys=True, fp_iters=k)
    dz0, grads = _launch_bwd(ys_p, dz, dld, w, stream_weights=stream_weights, n_sweeps=k + 1)
    dz0_p, grads_p = iaf_chain_bwd_ref(ys_p, dz, dld, *w, n_sweeps=k + 1)
    torch.cuda.synchronize()
    assert (iaf_chain_fwd.launches, iaf_chain_bwd.launches) == (before[0] + 1, before[1] + 1)
    scale = z_p.abs().flatten(1).max(1).values[:, None, None]
    assert torch.all((z - z_p).abs() <= 1e-4 * scale)
    torch.testing.assert_close(ld, ld_p, rtol=1e-4, atol=1e-4)
    _scaled_close(ys, ys_p)
    for got, want in zip((dz0, *grads), (dz0_p, *grads_p)):
        _scaled_close(got, want)
    again = _launch_fwd(z0, w, return_ys=True, stream_weights=stream_weights, fp_iters=k)
    assert all(map(torch.equal, (z, ld, ys), again))


@pytest.mark.parametrize("d,h,nh", [(16, 256, 1), (16, 256, 2), (32, 256, 3), (6, 100, 3),
                                    (5, 20, 3)])
def test_iaf_chain_jacobi_other_shapes_match_plain(dev, d, h, nh):
    """The Jacobi mode off the presets: no hidden layer, one, the largest D,
    partial or empty column slices, an odd D (streamed)."""
    w, z0, dz, dld = _chain_problem(dev, 20, nh=nh, d=d, h=h)
    _hold_to_plain_jacobi(w, z0, dz, dld, 3)


def _hold_to_plain_jacobi(w, z0, dz, dld, k):
    z, ld, ys = iaf_chain_fwd(z0, *w, return_ys=True, fp_iters=k)
    z_p, ld_p, ys_p = iaf_chain_fwd_ref(z0, *w, return_ys=True, fp_iters=k)
    dz0, grads = iaf_chain_bwd(ys_p, dz, dld, *w, n_sweeps=k + 1)
    dz0_p, grads_p = iaf_chain_bwd_ref(ys_p, dz, dld, *w, n_sweeps=k + 1)
    torch.cuda.synchronize()
    scale = z_p.abs().flatten(1).max(1).values[:, None, None]
    assert torch.all((z - z_p).abs() <= 1e-4 * scale)
    torch.testing.assert_close(ld, ld_p, rtol=1e-4, atol=1e-4)
    _scaled_close(ys, ys_p)
    for got, want in zip((dz0, *grads), (dz0_p, *grads_p)):
        if want.numel():
            _scaled_close(got, want)


@pytest.mark.parametrize("b", [7, 64])
def test_iaf_chain_jacobi_at_d_minus_1_is_the_sequential_chain(dev, b):
    """At K = D - 1 the Jacobi iterate is exact: the mode agrees with the
    sequential kernel within fp32 rounding, not bitwise (layer 0 is a full
    product there, D incremental FMAs here), and so does the backward at D
    sweeps against the backward at K + 1 = D."""
    w, z0, dz, dld = _chain_problem(dev, b)
    z_j, ld_j, ys_j = iaf_chain_fwd(z0, *w, return_ys=True, fp_iters=15)
    z_s, ld_s, ys_s = iaf_chain_fwd(z0, *w, return_ys=True)
    torch.cuda.synchronize()
    scale = z_s.abs().flatten(1).max(1).values[:, None, None]
    assert torch.all((z_j - z_s).abs() <= 1e-4 * scale)
    torch.testing.assert_close(ld_j, ld_s, rtol=1e-4, atol=1e-4)
    _scaled_close(ys_j, ys_s)


def test_iaf_chain_jacobi_geometry_and_graph_replay(dev):
    """The mode's larger partials still leave the shipped shape's weights in
    shared memory at every R, and both kernels replay in a CUDA graph bit
    for bit."""
    for b in (1, 9, 17, 33, 64):
        got = launch_geometry(b, 16, 256, 3, fp_iters=8)
        seq = launch_geometry(b, 16, 256, 3)
        assert got["weights_resident"] == 1 and got["max_active_clusters"] >= 1
        assert got["smem_bytes_per_cta"] > seq["smem_bytes_per_cta"]
    w, z0, dz, dld = _chain_problem(dev, 64)
    eager_f = iaf_chain_fwd(z0, *w, return_ys=True, fp_iters=8)
    eager_b = iaf_chain_bwd(eager_f[2], dz, dld, *w, n_sweeps=9)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_f = iaf_chain_fwd(z0, *w, return_ys=True, fp_iters=8)
        out_b = iaf_chain_bwd(out_f[2], dz, dld, *w, n_sweeps=9)
    graph.replay()
    torch.cuda.synchronize()
    assert all(map(torch.equal, out_f, eager_f))
    assert torch.equal(out_b[0], eager_b[0]) and all(map(torch.equal, out_b[1], eager_b[1]))


def test_iaf_chain_function_jacobi_equals_the_cpu(dev):
    """IAFChain at fp_iters = 8 on the card (forward at K, backward at K + 1
    sweeps) against the same Function on the CPU's plain versions."""
    g = torch.Generator().manual_seed(1)
    flows = TemporalFlows(16, 8, 256, 2, 3, log_var_bias_init=0.0, generator=g)
    z0 = torch.randn(16, 16, generator=g)
    outs = {}
    for d in (dev, "cpu"):
        f = flows.to(d)
        f.zero_grad()
        z = z0.detach().clone().to(d).requires_grad_(True)
        zt, ld = IAFChain.apply(z, *stack_chain([f.flows[min(t, 7)] for t in range(7)]), 8)
        (zt.square().sum() + ld.sum()).backward()
        outs[str(d)] = (zt.detach().cpu(), z.grad.cpu(), f.flows[0].blocks[0].weights[1].grad.cpu())
    for got, want in zip(outs[str(dev)], outs["cpu"]):
        _scaled_close(got, want)


def test_iaf_chain_jacobi_rejects_bad_modes(dev):
    w, z0, dz, dld = _chain_problem(dev, 4)
    with pytest.raises(ValueError):
        iaf_chain_fwd(z0, *w, fp_iters=-1)
    _, _, ys = iaf_chain_fwd(z0, *w, return_ys=True)
    with pytest.raises(ValueError):
        iaf_chain_bwd(ys, dz, dld, *w, n_sweeps=0)


# the sequential mode of the backward (n_sweeps = 0, JAX's adj_sweeps = 0):
# against its plain version and fp64, in both instantiations; 37 is not a
# multiple of the cluster rows (R = 8)
SEQ_BATCHES = [1, 16, 37, 64]


def _seq_case(dev, b, bias):
    g = torch.Generator().manual_seed(b)
    flows = TemporalFlows(16, 8, 256, 2, 3, log_var_bias_init=bias, generator=g)
    w = stack_chain([flows.to(dev).requires_grad_(False).flows[min(t, 7)] for t in range(7)])
    z0 = torch.randn(b, 16, generator=g).to(dev)
    dz = torch.randn(7, b, 16, generator=g).to(dev)
    dld = torch.randn(7, b, generator=g).to(dev)
    _, _, ys = iaf_chain_fwd_ref(z0, *w, return_ys=True)
    return w, z0, dz, dld, ys


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.double().abs().max()), 1e-30)


@pytest.mark.parametrize("b", SEQ_BATCHES)
@pytest.mark.parametrize("stream_weights", [False, True])
@pytest.mark.parametrize("bias", [0.0, -2.0])
def test_iaf_chain_sequential_bwd_matches_plain_and_fp64(dev, b, stream_weights, bias):
    """Near-identity flows (bias 0): within 1e-4 of each output's scale of
    the plain version.  The reference init (bias -2), whose gradients are
    ill-conditioned in fp32: against fp64 no worse than 4x the plain fp32
    version (or 1e-4 of scale), as chip_smoke.py holds the adjoint mode.
    Bit-identical on relaunch."""
    w, z0, dz, dld, ys = _seq_case(dev, b, bias)
    before = iaf_chain_bwd.launches
    got = _launch_bwd(ys, dz, dld, w, stream_weights=stream_weights, n_sweeps=0, z0=z0)
    again = _launch_bwd(ys, dz, dld, w, stream_weights=stream_weights, n_sweeps=0, z0=z0)
    want = iaf_chain_bwd_ref(ys, dz, dld, *w, n_sweeps=0, z0=z0)
    torch.cuda.synchronize()
    assert iaf_chain_bwd.launches == before + 2
    assert torch.equal(got[0], again[0]) and all(map(torch.equal, got[1], again[1]))
    pairs = list(zip((got[0], *got[1]), (want[0], *want[1])))
    if bias == 0.0:
        for g_, w_ in pairs:
            _scaled_close(g_, w_)
    else:
        want64 = iaf_chain_bwd_ref(ys.double(), dz.double(), dld.double(),
                                   *(x.double() for x in w), n_sweeps=0, z0=z0.double())
        for (g_, p_), e_ in zip(pairs, (want64[0], *want64[1])):
            assert _rel(g_, e_) <= max(4.0 * _rel(p_, e_), 1e-4)


def test_iaf_chain_sequential_bwd_replays_in_a_cuda_graph_and_equals_the_adjoint(dev):
    """Captured after an eager launch, the replay gives the eager bits; the
    gradients equal the adjoint mode's within 1e-4 of scale after the MADE
    masks (the raw entries the masks zero differ between the modes), and
    the adjoint's launch is not counted as a sequential one."""
    w, z0, dz, dld, ys = _seq_case(dev, 64, 0.0)
    eager = iaf_chain_bwd(ys, dz, dld, *w, n_sweeps=0, z0=z0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = iaf_chain_bwd(ys, dz, dld, *w, n_sweeps=0, z0=z0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and all(map(torch.equal, out[1], eager[1]))
    sequential = iaf_chain_bwd.sequential_launches
    adj = iaf_chain_bwd(ys, dz, dld, *w)
    assert iaf_chain_bwd.sequential_launches == sequential  # the adjoint is not counted
    _scaled_close(eager[0], adj[0])
    for g_, a_, w_ in zip(eager[1], adj[1], w):
        mask = (w_ != 0).to(g_.dtype)
        _scaled_close(g_ * mask, a_ * mask)


@pytest.mark.parametrize("d,h,nh", [(16, 256, 1), (16, 256, 2), (6, 100, 3), (5, 20, 3)])
def test_iaf_chain_sequential_bwd_other_shapes_match_plain(dev, d, h, nh):
    """Off the presets: no or one more hidden layer, partial or empty column
    slices, an odd D (streamed)."""
    w, z0, dz, dld = _chain_problem(dev, 20, nh=nh, d=d, h=h)
    _, _, ys = iaf_chain_fwd_ref(z0, *w, return_ys=True)
    got = iaf_chain_bwd(ys, dz, dld, *w, n_sweeps=0, z0=z0)
    want = iaf_chain_bwd_ref(ys, dz, dld, *w, n_sweeps=0, z0=z0)
    torch.cuda.synchronize()
    for g_, w_ in zip((got[0], *got[1]), (want[0], *want[1])):
        if w_.numel():
            _scaled_close(g_, w_)


def test_iaf_chain_function_under_the_override_equals_the_cpu(dev, monkeypatch):
    """IAFChain with ADJ_SWEEPS_OVERRIDE = 0: one forward and one backward
    launch in the sequential mode on the card, against the same Function on
    the CPU's plain versions."""
    from rlvae_tpu_torch.ops import iaf_kernels

    monkeypatch.setattr(iaf_kernels, "ADJ_SWEEPS_OVERRIDE", 0)
    g = torch.Generator().manual_seed(2)
    flows = TemporalFlows(16, 8, 256, 2, 3, log_var_bias_init=0.0, generator=g)
    z0 = torch.randn(16, 16, generator=g)
    outs = {}
    for d in (dev, "cpu"):
        f = flows.to(d)
        f.zero_grad()
        z = z0.detach().clone().to(d).requires_grad_(True)
        launches = (iaf_chain_bwd.launches, iaf_chain_bwd.sequential_launches)
        zt, ld = IAFChain.apply(z, *stack_chain([f.flows[min(t, 7)] for t in range(7)]))
        (zt.square().sum() + ld.sum()).backward()
        assert (iaf_chain_bwd.launches, iaf_chain_bwd.sequential_launches) == tuple(
            n + (d == dev) for n in launches)
        outs[str(d)] = (zt.detach().cpu(), z.grad.cpu(), f.flows[0].blocks[0].weights[1].grad.cpu())
    for got, want in zip(outs[str(dev)], outs["cpu"]):
        _scaled_close(got, want)


def test_research_models_launch_their_kernels(dev):
    """RIEM's forward launches the chol-bundle (its rejection sampler's
    volumes) and the metric bundle (its metric step); GUGUS's generate_hmc
    launches B4 at K=1, 1 + 20 (15 + 1) times, and equals the CPU's on the
    same draws; ``lvaega``'s training draw raises on the card (B4 has no
    backward)."""
    from rlvae_tpu_torch.convert import gugus_host_state, set_gugus_host_state
    from rlvae_tpu_torch.geometry import CentroidMetric
    from rlvae_tpu_torch.models.research import LVAE_GUGUS, RIEM

    g = torch.Generator().manual_seed(0)
    net = {"architecture": "mlp", "hidden_dims": [32], "dtype": "float32"}
    kw = dict(input_dim=(3, 8, 8), latent_dim=16, n_obs=3, warmup=0, encoder_config=net,
              decoder_config=net)
    x = torch.rand((4, 3, 3, 8, 8), generator=g)
    c = torch.randn((6, 16), generator=g)
    a = torch.randn((6, 16, 16), generator=g) / 4
    metric = CentroidMetric.create(c.numpy(), (a @ a.transpose(1, 2) + 0.1 * torch.eye(16)).numpy(),
                                   temperature=1.0)
    riem = RIEM(metric=metric, **kw).to(dev)
    before = chol_bundle.launches, metric_bundle.launches
    out = riem(x.to(dev), vi_index=2, generator=g)
    torch.cuda.synchronize()
    assert torch.isfinite(out.loss)
    assert (chol_bundle.launches - before[0], metric_bundle.launches - before[1]) == (2, 1)

    gugus = LVAE_GUGUS(variant="lvaeg2", use_riemann_prior=True, hidden_size=16, **kw)
    gugus.retrieve_metric_all(x)
    noise = {"gammas": torch.randn((20, 5, 16), generator=g), "unifs": torch.rand((20, 5), generator=g)}
    with torch.no_grad():
        want = gugus.generate_hmc(5, noise=noise)
        gugus.to(dev)
        before = hmc_terms.launches
        got = gugus.generate_hmc(5, noise={k: v.to(dev) for k, v in noise.items()})
    torch.cuda.synchronize()
    assert hmc_terms.launches - before == 1 + 20 * 16
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    lvaega = LVAE_GUGUS(variant="lvaega", use_riemann_prior=True, hidden_size=16, **kw).to(dev)
    set_gugus_host_state(lvaega, gugus_host_state(gugus))
    with pytest.raises(NotImplementedError):
        lvaega(x.to(dev), vi_index=0, train=True, generator=g)


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


@pytest.mark.parametrize("b", [1, 50, 64, 1000, 4096])
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


def test_posterior_hmc_train_forward_raises_without_a_backward(dev):
    """The HMC terms kernel has no backward (JAX's Pallas kernel has no VJP
    either): a train forward of the posterior-HMC model with grad enabled
    raises, naming it, instead of a silent zero gradient through the
    target; under no_grad it runs (200 terms launches)."""
    from pathlib import Path

    from rlvae_tpu_torch.geometry import load_metric
    from rlvae_tpu_torch.models import RlVAE

    metric = load_metric(Path(__file__).resolve().parents[1] / "data" / "pretrained" / "metric.npz")
    net = {"architecture": "mlp", "hidden_dims": [32]}
    model = RlVAE(input_dim=(3, 8, 8), n_flows=2, flow_hidden_size=32, metric=metric,
                  posterior_type="gaussian", sampling_method="hmc", encoder_config=net,
                  decoder_config=net).to(dev).train()
    x = torch.rand((2, 3, 3, 8, 8), device=dev)
    with pytest.raises(NotImplementedError, match="backward"):
        model(x, generator=torch.Generator(device=dev).manual_seed(0), train=True)
    before = hmc_terms.launches
    with torch.no_grad():
        out = model(x, generator=torch.Generator(device=dev).manual_seed(0))
    assert hmc_terms.launches == before + 200 and torch.isfinite(out.loss)


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
    """The kernels take 1 <= D <= 32: a D=8 bank launches them (G^{-1} of the
    shard, the HMC terms), equal to the CPU's plain versions; past 32 the
    raw wrappers raise on CUDA tensors, and the call sites take the plain
    versions instead (``plain_route``, counted), never launching."""
    from rlvae_tpu_torch.geometry import metric as gm
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.ops._launch import plain_route
    from rlvae_tpu_torch.parallel import create_mesh, g_inv_sharded, shard_metric

    mesh = create_mesh()
    for d, launched in ((8, True), (40, False)):
        rng = np.random.default_rng(5)
        a = rng.normal(size=(6, d, d)).astype(np.float32) * 0.3
        m = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(d, dtype=np.float32)
        metric = CentroidMetric.create(rng.normal(size=(6, d)).astype(np.float32), m, 0.9, 0.01)
        mt = CentroidMetric(metric.centroids.to(dev), metric.matrices.to(dev),
                            metric.temperature, metric.regularization)
        z = torch.tensor(rng.normal(size=(3, d)) * 0.3, dtype=torch.float32)
        before = (g_inv.launches, hmc_terms.launches, plain_route.calls)
        gi = g_inv_sharded(mesh, shard_metric(mesh, mt), z.to(dev))
        grad = gm.grad_log_sqrt_det_g_inv(mt, z.to(dev))
        after = (g_inv.launches, hmc_terms.launches, plain_route.calls)
        assert after == ((before[0] + 1, before[1] + 1, before[2]) if launched
                         else (before[0], before[1], before[2] + 2)), (d, before, after)
        torch.testing.assert_close(gi.cpu(), gm.g_inv(metric, z), rtol=1e-5, atol=1e-6)
        want = gm.grad_log_sqrt_det_g_inv(metric, z)
        assert float((grad.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())
        if not launched:
            with pytest.raises(ValueError):
                g_inv(z.to(dev), mt.centroids, mt.matrices, 1.0, 0.01)


BUNDLE_TOL = ((1e-5, 1e-6), (1e-4, 1e-4), (1e-4, 1e-4), (1e-3, 1e-3))  # G^-1, L, logdet, G


@pytest.mark.parametrize("b,k,geometry", [
    *((b, k, None) for k in (1, 50, 200, 20_000) for b in (1, 64, 1000)),
    # a given geometry (rows per CTA, warps per CTA, CTAs per cluster) in place
    # of the rule's, the bank summed in 1, 2, 7 or 40 ranges (CTAs x warps;
    # the rule's at K=20 000 and B=64 on an H100 is 6 x 16): one warp alone,
    # one warp for 4 rows in clusters of 2, clusters of 7, 5 warps for 8 rows
    # in clusters of 8; and 3 ranges for 5 rows in clusters of 3
    *((64, 20_000, g) for g in ((1, 1, 1), (4, 1, 2), (2, 1, 7), (8, 5, 8))), (5, 200, (2, 1, 3)),
])
def test_metric_bundle_and_g_inv_match_plain_and_fp64(dev, b, k, geometry):
    """Both kernels against their plain fp32 versions and an fp64 evaluation;
    the last rows of a batch lie far from every centroid (G^{-1} = lbd I).
    A given ``geometry`` launches ``metric_bundle_at_f32`` and
    ``g_inv_at_f32`` in place of the wrappers' rule."""
    c, m = _bank(k, 7 * k + b)
    rng = np.random.default_rng(b + 1)
    z = c[rng.integers(0, k, size=b)] + 0.05 * rng.normal(size=(b, 16))
    if b > 1:
        z[-2:] += 100.0
    zt, ct, mt = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (z, c, m))
    before = (metric_bundle.launches, g_inv.launches)
    if geometry is None:
        got = metric_bundle(zt, ct, mt, 4.0, 0.01)
        gi_k = g_inv(zt, ct, mt, 4.0, 0.01)
        assert (metric_bundle.launches, g_inv.launches) == (before[0] + 1, before[1] + 1)
    else:
        lib = kernel_library()
        got = hmc_sweep.metric_at(lib, "metric_bundle", zt, ct, mt, geometry)
        (gi_k,) = hmc_sweep.metric_at(lib, "g_inv", zt, ct, mt, geometry)
    plain = metric_bundle_ref(zt, ct, mt, 4.0, 0.01)
    want64 = metric_bundle_ref(zt.double(), ct.double(), mt.double(), 4.0, 0.01)
    torch.cuda.synchronize()
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


def test_metric_kernels_replay_in_a_cuda_graph(dev):
    """The chol-bundle, metric-bundle and G^{-1} launchers neither
    synchronise nor allocate (no workspace at any K): after a warm-up launch
    each captures into a CUDA graph, with one CTA a row (K=50) and with
    clusters (K=20 000), whose replay gives the eager launches' bits."""
    for k in (50, 20_000):
        c, m = _bank(k, 23)
        rng = np.random.default_rng(k + 1)
        z = c[rng.integers(0, k, size=64)] + 0.05 * rng.normal(size=(64, 16))
        zt, ct, mt = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (z, c, m))
        calls = (lambda: chol_bundle(zt, ct, mt, 4.0, 0.01 + 1e-6),
                 lambda: metric_bundle(zt, ct, mt, 4.0, 0.01),
                 lambda: (g_inv(zt, ct, mt, 4.0, 0.01),))
        eager = [call() for call in calls]
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = [call() for call in calls]
        graph.replay()
        torch.cuda.synchronize()
        for want, got in zip(eager, replayed):
            assert all(map(torch.equal, got, want)), k


@pytest.mark.parametrize("kernel", ["chol_bundle", "metric_bundle", "g_inv"])
def test_metric_geometry_matches_the_launchers(dev, kernel):
    """``metric_kernels.hmc_geometry`` of the metric kernels with their own
    cluster slots against the launchers' rule, read from the library; G^{-1}
    takes the metric bundle's geometry."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = metric_kernels.hmc_cluster_slots(dev, kernel)
    for k in (1, 37, 50, 200, 2000, 20_000):
        for b in list(range(1, 70)) + [100, 300, 1000]:
            g = metric_kernels.hmc_geometry(b, k, sms, slots, kernel)
            assert metric_kernels.launch_hmc_geometry(b, k, dev, kernel) == g, (b, k)
            assert g == metric_kernels.launch_hmc_geometry(b, k, dev, "metric_bundle") or (
                kernel == "chol_bundle")
            assert 1 <= g.ctas <= 8 and (g.ctas == 1 or g.clusters <= slots(*g[:3])), (b, k, g)


def test_sharded_g_inv_shard_views_launch_g_inv(dev):
    """``g_inv_sharded`` hands the G^{-1} kernel views into one contiguous
    padded bank (``shard_metric``): each shard starts 64-byte aligned, so the
    kernel's bulk copies take it, and each shard's G^{-1} equals its plain
    version."""
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.parallel import shard_metric
    from rlvae_tpu_torch.parallel.mesh import Mesh

    c, m = _bank(37, 6)
    metric = CentroidMetric.create(c, m, temperature=0.5, regularization=0.01)
    metric = CentroidMetric(metric.centroids.to(dev), metric.matrices.to(dev),
                            metric.temperature, metric.regularization)
    z = torch.tensor(c[:9] + 0.05, dtype=torch.float32, device=dev)
    for ep in (2, 4):
        for index in range(ep):
            shard = shard_metric(Mesh(dp=1, ep=ep, data_index=0, model_index=index), metric)
            assert shard.centroids.data_ptr() % 64 == 0 and shard.matrices.data_ptr() % 64 == 0
            before = g_inv.launches
            got = g_inv(z, shard.centroids, shard.matrices, 4.0, 0.0)
            assert g_inv.launches == before + 1
            torch.testing.assert_close(got, g_inv_ref(z, shard.centroids, shard.matrices, 4.0, 0.0),
                                       rtol=1e-5, atol=1e-6)


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


def test_g_inv_and_g_pair_on_the_card_equals_the_cpu(dev):
    """MetricBundleGInvG: the forward is one metric-bundle launch whose (G^{-1},
    G) it returns bit for bit; its backward (the plain recompute) gives the
    cotangents of z, the centroids and the matrices, and a second derivative
    in z through ``create_graph=True``, all as on the CPU."""
    from rlvae_tpu_torch.ops.metric_kernels import MetricBundleGInvG

    c, m = _bank(200, 4)
    rng = torch.Generator().manual_seed(2)
    w1, w2 = torch.randn(7, 16, 16, generator=rng), torch.randn(7, 16, 16, generator=rng)
    u = torch.randn(7, 16, generator=rng)
    grads = []
    for device in ("cpu", dev):
        leaves = [torch.tensor(a, dtype=torch.float32, device=device, requires_grad=True)
                  for a in (c[:7] + 0.05, c, m)]
        zz, cc, mm = leaves
        before = metric_bundle.launches
        gi, g = MetricBundleGInvG.apply(zz, cc, mm, 1.0 / 0.7 ** 2, 0.01)
        assert metric_bundle.launches == before + (1 if zz.is_cuda else 0)
        if zz.is_cuda:
            want = metric_bundle(zz.detach(), cc.detach(), mm.detach(), 1.0 / 0.7 ** 2, 0.01)
            assert torch.equal(gi, want[0]) and torch.equal(g, want[3])
        loss = (gi * w1.to(device)).sum() + (g * w2.to(device)).sum()
        (gz,) = torch.autograd.grad(loss, zz, create_graph=True)
        ((gz * u.to(device)).sum() + loss).backward()
        grads.append([t.grad.cpu() for t in leaves])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4 * want.abs().max())


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


@pytest.mark.parametrize("m,n,k", [(128, 12288, 1024), (37, 300, 1024), (1, 777, 513),
                                   (129, 777, 2049)])
def test_decode_mse_past_512_hidden_units(dev, m, n, k):
    """K > 512 (``mlp_rlvae``'s decoder: 1024) on the wide kernels
    (``csrc/decode_mse_wide.cu``): the same tolerances, rw = 0 rows exactly
    zero, bit-identical on relaunch; the dW/db entry reading the dp that
    the dh entry left (DecodeMSE's backward) gives the bits of its own."""
    from rlvae_tpu_torch.ops.recon_kernels import wide_dp

    _hold_decode_to_plain(dev, m, n, k)
    h, w, b, x, rw = _decode_problem(dev, m, n, k)
    g = torch.tensor(1.0, device=dev)
    dp = wide_dp(h, x)
    assert dp.shape == (m, n)
    dh = decode_mse_bwd_dh(h, w, b, x, rw, g, dp)
    assert torch.equal(dh, decode_mse_bwd_dh(h, w, b, x, rw, g))
    shared, own = decode_mse_bwd_dw(h, w, b, x, rw, g, dp), decode_mse_bwd_dw(h, w, b, x, rw, g)
    assert all(torch.equal(a, c) for a, c in zip(shared, own))


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
    with pytest.raises(ValueError):  # no hidden unit (any K >= 1 runs: K > 512 the wide kernels)
        hw = torch.zeros((8, 0), dtype=torch.bfloat16, device=dev)
        decode_mse(hw, torch.zeros((16, 0), device=dev), b, x, rw)
    with pytest.raises(RuntimeError):
        decode_mse(h, w.requires_grad_(True), b, x, rw)


_PORT_KERNELS = {"chol_bundle_kernel": chol_bundle, "iaf_chain_fwd_kernel": iaf_chain_fwd,
                 "metric_bundle_kernel<false>": g_inv}


def _kernel_calls(fn, attempts=3):
    """Launches of the chol-bundle, IAF chain and G^{-1} in one call of
    ``fn`` (idempotent), by profiler name (G^{-1} is
    ``metric_bundle_kernel<R, false>``), beside the wrappers' counters.  The
    call is profiled in the active step of a schedule after a warm-up step
    that runs ``fn`` too: a session started cold, in a process that had
    profiled before, missed its first milliseconds of device events.  A
    call whose profiled launches differ from the counted ones is profiled
    again, and the counters give the exact counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            before = {k: w.launches for k, w in _PORT_KERNELS.items()}
            fn()
            torch.cuda.synchronize()
            counted = {k: w.launches - before[k] for k, w in _PORT_KERNELS.items()}
            prof.step()
        calls = dict.fromkeys(_PORT_KERNELS, 0)
        for evt in prof.key_averages():
            for name in ("chol_bundle_kernel", "iaf_chain_fwd_kernel", "metric_bundle_kernel"):
                if name in evt.key:
                    key = name + ("<false>" if name == "metric_bundle_kernel" else "")
                    if key in calls and (name != "metric_bundle_kernel" or "false>" in evt.key):
                        calls[key] += int(evt.count)
        if calls == counted:
            break
    return calls, counted


@pytest.mark.parametrize("platforms", [("cuda",), ("cpu", "cuda")])
def test_exported_programs_launch_the_eager_kernels(dev, tmp_path, platforms):
    """An exported reconstruct and generate on the card launch the eager
    path's kernels (reconstruct: the chol-bundle twice, the IAF chain once;
    generate: G^{-1} and the IAF chain once), by the wrappers' counts and
    by profiler name, and equal it bit for bit; a bundle traced on the CPU
    and listing both platforms runs on the card the same way."""
    from rlvae_tpu_torch import ModelManager, PRESETS
    from rlvae_tpu_torch.export import export_model, load_exported

    cfg = {**PRESETS["riemannian_flow_vae"], "input_dim": [3, 16, 16], "n_flows": 3}
    trace_dev = "cpu" if "cpu" in platforms else dev
    manager = ModelManager.from_config(cfg, seed=0, device=dev)
    tracer = ModelManager.from_config(cfg, seed=0, device=trace_dev)
    export_model(tracer, tmp_path, ops=("reconstruct", "generate"), buckets=(8,), n_obs=4,
                 platforms=platforms)
    bundle = load_exported(tmp_path, device=dev)
    x = np.random.default_rng(0).uniform(size=(8, 4, 3, 16, 16)).astype(np.float32)
    seeds = np.arange(8, dtype=np.uint32) * 1000
    cases = {"reconstruct": (x, lambda: manager.reconstruct_rows(x, seed=0),
                             {"chol_bundle_kernel": 2, "iaf_chain_fwd_kernel": 1}),
             "generate": (seeds, lambda: manager.generate_rows(seeds, n_obs=4),
                          {"metric_bundle_kernel<false>": 1, "iaf_chain_fwd_kernel": 1})}
    for op, (batch, eager, want) in cases.items():
        want = {**dict.fromkeys(_PORT_KERNELS, 0), **want}
        bundle.run(op, batch)  # warm
        for fn in (eager, lambda: bundle.run_rows(op, batch)):
            calls, counted = _kernel_calls(fn)
            assert counted == want, (op, counted)
            # every launched kernel, and no other, seen by the profiler
            assert all((calls[k] > 0) == (want[k] > 0) and calls[k] <= want[k]
                       for k in want), (op, calls)
        np.testing.assert_array_equal(bundle.run(op, batch), eager().cpu().numpy())


def test_hmc_terms_registered_op_matches_plain(dev):
    """``rlvae::hmc_terms`` (B4 as a registered op, what an exported chain
    calls) launches the kernel once, gives the wrapper's bits, and holds the
    plain version at the kernel's tolerances."""
    from rlvae_tpu_torch.ops import export_ops

    c, m = _bank(50, 3)
    rng = np.random.default_rng(5)
    z = c[rng.integers(0, 50, size=64)] + 0.05 * rng.normal(size=(64, 16))
    zt, ct, mt = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (z, c, m))
    args = (4.0, 0.01, float(np.log(np.float32(1e-10))))
    before = hmc_terms.launches
    got = export_ops.hmc_terms(zt, ct, mt, *args)
    torch.cuda.synchronize()
    assert hmc_terms.launches == before + 1
    wrapper = hmc_terms(zt, ct, mt, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, wrapper))
    plain = hmc_terms_ref(zt, ct, mt, *args)
    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=1e-5)
    _scaled_close(got[1], plain[1])


@pytest.mark.parametrize("method", ["official", "hmc"])
def test_exported_chain_replays_its_eager_chain(dev, tmp_path, method):
    """The exported prior chain (one scan loop op, B4's registered op in its
    body) on the card: the eager chain's 1601 B4 launches per call and its
    rows bit for bit, at a full bucket and a padded one."""
    from rlvae_tpu_torch import ModelManager, PRESETS
    from rlvae_tpu_torch.export import export_model, load_exported

    cfg = {**PRESETS["riemannian_flow_vae"], "input_dim": [3, 16, 16], "n_flows": 3}
    manager = ModelManager.from_config(cfg, seed=0, device=dev)
    m = export_model(manager, tmp_path, ops=("generate",), buckets=(4,), n_obs=4,
                     generate_method=method)
    assert m["programs"]["generate"]["4"]["registered_ops"]["hmc_terms"] == 1 + 16
    bundle = load_exported(tmp_path, device=dev)
    seeds = np.asarray([3, 1000, 3, 77], np.uint32)
    want = manager.generate_rows(seeds, method, n_obs=4).cpu().numpy()
    for batch, rows in ((seeds, want), (seeds[:3], want[:3])):
        before = hmc_terms.launches
        got = bundle.run("generate", batch)
        assert hmc_terms.launches - before == 1601
        np.testing.assert_array_equal(got, rows)


# ---------------------------------------------------------------------------
# every latent width: B1, B4, B6, B7, B8 at D = 1..32, the plain route past it
# ---------------------------------------------------------------------------

BANK_KERNELS = ("chol_bundle", "hmc_terms", "metric_bundle", "g_inv", "hmc_partials")
LATENT_DIMS = (1, 2, 5, 8, 12, 16, 24, 31, 32)


@pytest.mark.parametrize("d", LATENT_DIMS)
@pytest.mark.parametrize("kernel", BANK_KERNELS)
def test_bank_kernels_at_every_width(dev, kernel, d):
    """The kernel at width D against its plain version and fp64 at K = 1, 50,
    200 and B = 1, 64 (chip_smoke.py's ``bank_kernel_case``: the kernels
    phase's tolerances, L's zero upper triangle, G bitwise symmetric, far
    rows exact, bit-identical on relaunch), replayed bitwise in a CUDA graph
    at K = 200, B = 64."""
    cs = _chip_smoke()
    for k in (1, 50, 200):
        for b in (1, 64):
            case, _ = cs.bank_kernel_case(torch, dev, kernel, d, k, b, replay=(k == 200 and b == 64))
            assert case["ok"], case


@pytest.mark.parametrize("kernel", BANK_KERNELS)
def test_bank_kernels_at_d32_on_a_dataset_sized_bank(dev, kernel):
    """D = 32, K = 20 000, B = 64 (clusters of the width-32 instances),
    replayed bitwise in a CUDA graph; its geometry the Python rule's."""
    cs = _chip_smoke()
    case, _ = cs.bank_kernel_case(torch, dev, kernel, 32, 20_000, 64, replay=True)
    assert case["ok"], case
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = metric_kernels.hmc_cluster_slots(dev, kernel, 32)
    for b in (1, 37, 64, 1000):
        for k in (1, 50, 200, 2000, 20_000):
            g = metric_kernels.hmc_geometry(b, k, sms, slots, kernel, 32)
            assert metric_kernels.launch_hmc_geometry(b, k, dev, kernel, 32) == g, (b, k)
            assert g.rows <= 4 and g.warps <= 8, g


def test_plain_route_past_the_envelope_launches_nothing(dev):
    """A latent-48 metric and an H = 512 chain on the card: the call sites
    take the plain versions (``plain_route.calls`` counts them), no kernel
    launches, and the results equal the CPU's."""
    from rlvae_tpu_torch.geometry import metric as gm
    from rlvae_tpu_torch.geometry.metric import CentroidMetric
    from rlvae_tpu_torch.ops._launch import plain_route
    from rlvae_tpu_torch.samplers.hmc import _terms_fn

    cs = _chip_smoke()
    c, m = cs.latent_bank(48, 50, 3)
    metric = CentroidMetric.create(c, m, 7.0, 0.01)
    on_dev = CentroidMetric(metric.centroids.to(dev), metric.matrices.to(dev), 7.0, 0.01)
    z = torch.tensor(cs.latent_rows(c, 9, 4))
    counters = (chol_bundle, metric_bundle, g_inv, hmc_terms, hmc_partials, iaf_chain_fwd)
    before = [f.launches for f in counters] + [plain_route.calls]
    got = (gm.chol_g_inv(on_dev, z.to(dev)), gm.g(on_dev, z.to(dev)), gm.g_inv(on_dev, z.to(dev)),
           *_terms_fn(on_dev)(z.to(dev)))
    want = (gm.chol_g_inv(metric, z), gm.g(metric, z), gm.g_inv(metric, z),
            *_terms_fn(metric)(z))
    flows = TemporalFlows(16, n_flows=2, hidden_size=512, log_var_bias_init=0.0)
    z0 = torch.randn(5, 16)
    from rlvae_tpu_torch.flows import apply_temporal_flows

    with torch.no_grad():
        chain = apply_temporal_flows(flows.to(dev), z0.to(dev), 4)
        chain_cpu = apply_temporal_flows(flows.cpu(), z0, 4)
    after = [f.launches for f in counters] + [plain_route.calls]
    assert after[:-1] == before[:-1] and after[-1] - before[-1] == 5, (before, after)
    for a, b in zip((*got, *chain), (*want, *chain_cpu)):
        scale = max(float(b.abs().max()), 1.0)
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale


# ---------------------------------------------------------------------------
# the visualization fields, the flow zoo and the slope timers, card vs CPU
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def test_viz_fields_on_the_card_equal_the_cpu(dev, tmp_path):
    """Each plotting module's fields from the card's latents, on the card
    (B1, B2, B6, B7 launched) and on the CPU, within chip_smoke's VIZ_TOL;
    the default preset's architecture at 16x16 frames and 3 flows."""
    from rlvae_tpu_torch import ModelManager, PRESETS
    from rlvae_tpu_torch.data import generate_cyclic_sequences
    from rlvae_tpu_torch.viz import VisualizationConfig, VisualizationLevel
    from rlvae_tpu_torch.viz.base import SharedForward

    cs = _chip_smoke()
    cfg_model = {**PRESETS["riemannian_flow_vae"], "input_dim": [3, 16, 16], "n_flows": 3}
    card = ModelManager.from_config(cfg_model, seed=0, device=dev).model
    cpu = ModelManager.from_config(cfg_model, seed=0, device="cpu").model
    x = generate_cyclic_sequences(4, n_obs=4, image_size=(16, 16), seed=1)
    z = SharedForward()(card, x, 0).z.float().cpu().numpy()
    cfg = VisualizationConfig(level=VisualizationLevel.FULL, enable_fancy_plots=True,
                              disable_curvature=False)
    out, total = cs.viz_module_fields(torch, card, cpu, z, cfg, tmp_path)
    assert all(total[k] > 0 for k in ("chol_bundle", "iaf_chain_fwd", "metric_bundle", "g_inv"))
    assert out["interactive"]["launches"]["metric_bundle"] == 1 + 2 + 120 + 2


def test_flow_zoo_on_the_card_equals_the_cpu(dev):
    out = _chip_smoke().zoo_checks(torch, dev)
    assert out["maf_roundtrip"] <= out["tolerance"]


def test_pixelcnn_on_the_card_equals_the_cpu(dev):
    out = _chip_smoke().pixelcnn_checks(torch, dev)
    assert out["steps"] == 784 and out["loss_rel"] <= out["tolerance"]["logits"]


def test_slope_timers_time_b1_on_the_card(dev):
    from rlvae_tpu_torch.geometry import load_metric

    cs = _chip_smoke()
    metric = load_metric(cs.PRETRAINED / "metric_T0.7_scaled.npz",
                         temperature_override=3.0).to(dev)
    out = cs.slope_timer_checks(torch, metric)
    assert out["scan_ms"] > 0 and out["fori_ms"] > 0
