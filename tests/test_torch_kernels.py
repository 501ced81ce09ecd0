"""The CUDA kernels against their plain PyTorch versions on the card.

Runs only where a CUDA card is present (marker ``cuda``; skipped with a
reason elsewhere).  On the card: ``python -m pytest tests/test_torch_kernels.py``.
Tolerances as in chip_smoke.py: chol-bundle |k-p| <= 1e-5 + 1e-4|p|
(fp32, other summation order, amplified by the factorization's
conditioning); IAF chain within 1e-4 of each transition's largest |z|;
IAF-chain backward (near-identity flows) within 1e-4 of each output's
largest entry, the forward's residual ys within 1e-4 of its scale; HMC
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
output bit-identical from one launch to the next."""

import numpy as np
import pytest
import torch

from rlvae_tpu_torch.flows import TemporalFlows
from rlvae_tpu_torch.ops.iaf_kernels import (
    IAFChain,
    iaf_chain_bwd,
    iaf_chain_bwd_ref,
    iaf_chain_fwd,
    iaf_chain_fwd_ref,
    stack_chain,
)
from rlvae_tpu_torch.ops import metric_kernels, recon_kernels
from rlvae_tpu_torch.ops.metric_kernels import (
    chol_bundle,
    chol_bundle_ref,
    g_inv,
    g_inv_ref,
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


@pytest.mark.parametrize("b", [1, 7, 64])
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


@pytest.mark.parametrize("b", [1, 16, 64])
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


@pytest.mark.parametrize("m,n,k", [(128, 12288, 512), (37, 300, 512), (512, 12288, 512),
                                   (37, 300, 64), (1, 1, 1)])
def test_decode_mse_matches_plain_and_fp64(dev, m, n, k):
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


@pytest.mark.parametrize("ranges", [1, 7, 192])
def test_decode_mse_dh_any_split_of_the_columns(dev, monkeypatch, ranges):
    """dh sums its column ranges in a second pass; any count of ranges gives
    the plain version's dh (the split only moves fp32 rounding)."""
    h, w, b, x, rw = _decode_problem(dev, 128, 12288)
    g = torch.tensor(0.5, device=dev)
    monkeypatch.setattr(recon_kernels, "dh_ranges", lambda m, n, device: ranges)
    dh = decode_mse_bwd_dh(h.float(), w, b, x, rw, g)
    torch.cuda.synchronize()
    _within_scale(dh, decode_mse_dh_ref(h.float(), w, b, x, rw, g))


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
