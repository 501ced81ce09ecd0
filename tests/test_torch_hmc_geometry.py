"""The launch geometry of the kernels of ``csrc/hmc_bank.cuh``'s front half,
on the CPU.

``hmc_geometry`` is the rule of the launchers in ``csrc/hmc_terms.cu`` and
``csrc/hmc_partials.cu`` (B4, B8), ``csrc/chol_bundle.cu`` (B1) and
``csrc/metric_bundle.cu`` (B6, B7), one argument telling the kernels apart
(``hmc_geometry`` in ``csrc/hmc_bank.cuh``); the card tests
``test_hmc_geometry_matches_the_launchers`` and
``test_metric_geometry_matches_the_launchers``
(``tests/test_torch_kernels.py``) hold it to the library's own answer with
the card's cluster slots.  Here, with the slots an H100 reports
(``cudaOccupancyMaxActiveClusters``, ``python -m
rlvae_tpu_torch.ops.hmc_sweep [--kernel ...]``) and with a card of more and
fewer SMs, for each kernel: every row and every chunk of the bank is summed
once, by ranges of whole chunks in (cluster rank, warp) order; clusters stay
within the portable 8 CTAs and fit in one wave; a small bank is one range;
G^{-1} takes the metric bundle's geometry.
"""

import pytest

from rlvae_tpu_torch.ops.metric_kernels import (
    HMC_CHUNK,
    HMC_MIN_CTA_CHUNKS,
    hmc_geometry,
    hmc_max_warps,
)

# clusters of C CTAs of 16 warps (or of 8 rows) an H100 (132 SMs) holds at
# once (hmc_sweep); CTAs of at most 8 warps and 4 rows fit twice on an SM
H100_SLOTS = {8: 15, 7: 15, 6: 17, 5: 22, 4: 30, 3: 44, 2: 66, 1: 132}


def h100_slots(rows, warps, ctas):
    return H100_SLOTS[ctas] * (2 if warps <= 8 and rows <= 4 else 1)


def even_slots(sms):
    return lambda rows, warps, ctas: sms // ctas


CARDS = {"h100": (132, h100_slots), "small": (16, even_slots(16)),
         "large": (264, even_slots(264))}
BANKS = (1, 3, 4, 5, 37, 40, 50, 127, 128, 200, 255, 256, 257, 1000, 2000, 5000, 20_000)
BATCHES = list(range(1, 70)) + [100, 127, 128, 129, 300, 1000, 1024, 4096]


def ranges(k, g):
    """The (rank, warp) -> [begin, end) chunk ranges of csrc/hmc_bank.cuh's
    bank_sums, as it computes them."""
    chunks = -(-k // HMC_CHUNK)
    per_cta = -(-chunks // g.ctas)
    out = {}
    for rank in range(g.ctas):
        cta_begin = min(rank * per_cta, chunks)
        cta_end = min(cta_begin + per_cta, chunks)
        per_warp = -(-(cta_end - cta_begin) // g.warps)
        for warp in range(g.warps):
            begin = min(cta_begin + warp * per_warp, cta_end)
            out[rank, warp] = (begin, min(begin + per_warp, cta_end))
    return out


@pytest.mark.parametrize("card", sorted(CARDS))
def test_every_row_and_chunk_is_summed_once_in_order(card):
    sms, slots = CARDS[card]
    for k in BANKS:
        chunks = -(-k // HMC_CHUNK)
        for b in BATCHES:
            g = hmc_geometry(b, k, sms, slots)
            assert g.rows in (1, 2, 4, 8) and 1 <= g.ctas <= 8, (b, k, g)
            assert min(g.rows, 8) <= g.warps <= hmc_max_warps(g.rows), (b, k, g)
            # cluster q owns rows [q*R, (q+1)*R) below B: each row once, no empty cluster
            assert g.clusters == -(-b // g.rows) and (g.clusters - 1) * g.rows < b
            # the (rank, warp) ranges, taken in that order, tile the chunks once
            spans = [ranges(k, g)[key] for key in sorted(ranges(k, g))]
            covered = [c for begin, end in spans for c in range(begin, end)]
            assert covered == list(range(chunks)), (b, k, g)


@pytest.mark.parametrize("card", sorted(CARDS))
def test_small_banks_take_one_range_and_large_ones_a_cluster(card):
    sms, slots = CARDS[card]
    for k in BANKS:
        chunks = -(-k // HMC_CHUNK)
        for b in BATCHES:
            g = hmc_geometry(b, k, sms, slots)
            if chunks < 2 * HMC_MIN_CTA_CHUNKS:
                assert g.ctas == 1, (b, k, g)
            else:  # every CTA of a cluster sums at least HMC_MIN_CTA_CHUNKS chunks
                assert chunks // g.ctas >= HMC_MIN_CTA_CHUNKS, (b, k, g)
            if g.ctas > 1:  # one wave: the card holds every cluster at once
                assert g.clusters <= slots(g.rows, g.warps, g.ctas), (b, k, g)


def test_h100_geometry_at_the_measured_shapes():
    """The shapes the sweep measured on an H100 (PERF.md): one CTA a row at
    K=50 and 200; at K=20 000 a cluster of 8 for B=1 and 37, of 6 for B=64
    (16 row groups of 4; 15 clusters of 8 fit, 17 of 6), and one CTA of 8
    rows for B=1000."""
    sms = 132
    want = {(1, 50): (1, 13, 1, 1), (64, 50): (1, 13, 1, 64), (64, 200): (1, 16, 1, 64),
            (1000, 50): (8, 8, 1, 125), (1, 20_000): (1, 16, 8, 1),
            (37, 20_000): (4, 16, 8, 10), (64, 20_000): (4, 16, 6, 16),
            (1000, 20_000): (8, 8, 1, 125)}
    for (b, k), g in want.items():
        assert tuple(hmc_geometry(b, k, sms, h100_slots)) == g, (b, k)


def test_h100_geometry_at_the_adaptive_samplers_shapes():
    """The adaptive sampler's calibration runs one chain per centroid (B=50
    at K=50: one CTA a row) and its warm-start pool B=4096 (512 CTAs of 8
    rows and 8 warps); the posterior HMC B=64 at K=200.  At K=20 000 the
    4096 rows' 512 clusters are more than the card holds at any cluster
    size, so the rule cuts the cluster to 1 CTA."""
    want = {(50, 50): (1, 13, 1, 50), (4096, 50): (8, 8, 1, 512), (64, 200): (1, 16, 1, 64),
            (4096, 200): (8, 8, 1, 512), (4096, 20_000): (8, 8, 1, 512)}
    for (b, k), g in want.items():
        assert tuple(hmc_geometry(b, k, 132, h100_slots)) == g, (b, k)
    # with a cluster of 8 the bank would split 8 ways; 512 > 15 clusters fit
    assert -(-20_000 // HMC_CHUNK) // HMC_MIN_CTA_CHUNKS >= 8 and h100_slots(8, 8, 8) < 512


@pytest.mark.parametrize("b", [1, 37, 64, 1000])
def test_padding_within_the_last_chunk_keeps_the_geometry(b):
    """37 centroids padded to 40 (the sharded path's padding to a multiple of
    4 shards) fill the same chunks: same geometry, same ranges, so the sums
    are taken in the same order and the padded centroids add exact zeros."""
    for k, padded in ((37, 40), (50, 52), (1999, 2000), (19_997, 20_000)):
        g = hmc_geometry(b, k, 132, h100_slots)
        assert g == hmc_geometry(b, padded, 132, h100_slots)
        assert ranges(k, g) == ranges(padded, g)


# The metric kernels' instances of the rule (csrc/hmc_bank.cuh BankKernel):
# B1 and B6 (B7 launches at B6's geometry).  Without the gradient's second sum
# a CTA may have 16 warps at any rows, and each kernel's slots are its own:
# clusters of C CTAs an H100 holds at once, measured for B1 and B6 alike at
# rows 1 and 8 (hmc_sweep --kernel ...: a CTA of 16 warps takes an SM, one of
# 8 warps fits twice); the rule asks for slots only at 16 warps.
METRIC_KERNELS = ("chol_bundle", "metric_bundle")
H100_METRIC_SLOTS = {16: {8: 15, 7: 15, 6: 17, 5: 22, 4: 30, 3: 39, 2: 66, 1: 132},
                     8: {8: 30, 7: 32, 6: 39, 5: 47, 4: 62, 3: 79, 2: 132, 1: 264}}


def h100_metric_slots(rows, warps, ctas):
    return H100_METRIC_SLOTS[16 if warps > 8 else 8][ctas]


METRIC_CARDS = {"h100": (132, h100_metric_slots), "small": (16, even_slots(16)),
                "large": (264, even_slots(264))}


@pytest.mark.parametrize("kernel", METRIC_KERNELS)
@pytest.mark.parametrize("card", sorted(METRIC_CARDS))
def test_metric_kernels_sum_every_row_and_chunk_once_in_order(card, kernel):
    sms, slots = METRIC_CARDS[card]
    for k in BANKS:
        chunks = -(-k // HMC_CHUNK)
        for b in BATCHES:
            g = hmc_geometry(b, k, sms, slots, kernel)
            assert g.rows in (1, 2, 4, 8) and 1 <= g.ctas <= 8, (b, k, g)
            assert min(g.rows, 8) <= g.warps <= hmc_max_warps(g.rows, kernel) == 16, (b, k, g)
            assert g.clusters == -(-b // g.rows) and (g.clusters - 1) * g.rows < b
            spans = [ranges(k, g)[key] for key in sorted(ranges(k, g))]
            covered = [c for begin, end in spans for c in range(begin, end)]
            assert covered == list(range(chunks)), (b, k, g)


@pytest.mark.parametrize("kernel", METRIC_KERNELS)
@pytest.mark.parametrize("card", sorted(METRIC_CARDS))
def test_metric_kernels_take_one_range_for_small_banks_and_one_wave(card, kernel):
    sms, slots = METRIC_CARDS[card]
    for k in BANKS:
        chunks = -(-k // HMC_CHUNK)
        for b in BATCHES:
            g = hmc_geometry(b, k, sms, slots, kernel)
            if chunks < 2 * HMC_MIN_CTA_CHUNKS:
                assert g.ctas == 1, (b, k, g)
            else:
                assert chunks // g.ctas >= HMC_MIN_CTA_CHUNKS, (b, k, g)
            if g.ctas > 1:
                assert g.clusters <= slots(g.rows, g.warps, g.ctas), (b, k, g)


@pytest.mark.parametrize("kernel", ["chol_bundle", "metric_bundle", "g_inv"])
def test_h100_geometry_of_the_metric_kernels(kernel):
    """At the train step's B=16 and the serving bucket's B=64, K = 50, 200
    and 20 000: one CTA a row with a warp a chunk (up to 16) at K <= 200; at
    K=20 000 clusters of 6 (15 clusters of 8 fit, 17 of 6), of rows 1 at
    B=16 and 4 at B=64; at B=1000, rows of 8 with 13 or 16 warps (B4 and
    B8 have at most 8 there)."""
    want = {(16, 50): (1, 13, 1, 16), (16, 200): (1, 16, 1, 16), (16, 20_000): (1, 16, 6, 16),
            (64, 50): (1, 13, 1, 64), (64, 200): (1, 16, 1, 64), (64, 20_000): (4, 16, 6, 16),
            (1000, 50): (8, 13, 1, 125), (1000, 20_000): (8, 16, 1, 125)}
    for (b, k), g in want.items():
        assert tuple(hmc_geometry(b, k, 132, h100_metric_slots, kernel)) == g, (b, k)
    assert tuple(hmc_geometry(1000, 50, 132, h100_slots)) == (8, 8, 1, 125)


def test_g_inv_takes_the_metric_bundles_geometry():
    """G^{-1} launches at the bundle's geometry (the same ranges, so the same
    bits), whatever the card."""
    for sms, slots in METRIC_CARDS.values():
        for k in BANKS:
            for b in BATCHES:
                assert (hmc_geometry(b, k, sms, slots, "g_inv")
                        == hmc_geometry(b, k, sms, slots, "metric_bundle")), (b, k)


@pytest.mark.parametrize("kernel", METRIC_KERNELS)
@pytest.mark.parametrize("b", [1, 16, 64, 1000])
def test_metric_kernels_padding_keeps_the_geometry(kernel, b):
    for k, padded in ((37, 40), (50, 52), (1999, 2000), (19_997, 20_000)):
        g = hmc_geometry(b, k, 132, h100_metric_slots, kernel)
        assert g == hmc_geometry(b, padded, 132, h100_metric_slots, kernel)
        assert ranges(k, g) == ranges(padded, g)
