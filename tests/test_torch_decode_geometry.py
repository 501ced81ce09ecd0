"""The decode+MSE kernels' launch geometry, on the CPU.

``decode_geometry`` (``rlvae_tpu_torch/ops/recon_kernels.py``) is the rule
the wrappers launch ``csrc/decode_mse.cu`` with; the kernels validate it and
split N and M as ``column_range`` and the row-group walk below mirror them.  Here,
with the cluster slots an H100 reports for one dh CTA per SM
(``cudaOccupancyMaxActiveClusters``; ``python -m
rlvae_tpu_torch.ops.decode_sweep`` prints them) and with cards of fewer and
more SMs: every column and every row tile is covered exactly once for every
M from 1 to 4096, no CTA owns more columns than its shared memory holds,
clusters stay within the portable 8, and at the fast preset's N = 12288 each
entry point fits in one wave.
"""

import pytest

from rlvae_tpu_torch.ops.recon_kernels import (
    DH_BLOCKS,
    DH_ROWS,
    DW_BLOCKS,
    FWD_BLOCKS,
    FWD_ROWS,
    MAX_CLUSTER,
    DecodeGeometry,
    decode_geometry,
)

# clusters of C CTAs of one SM each an H100 (132 SMs) holds at once
H100_SLOTS = {8: 15, 7: 15, 6: 17, 5: 22, 4: 30, 3: 44, 2: 66, 1: 132}


def h100_slots(k, cluster):
    return H100_SLOTS[cluster]


def even_slots(sms):
    return lambda k, cluster: sms // cluster


CARDS = {"h100": (132, h100_slots), "small": (16, even_slots(16)),
         "large": (264, even_slots(264))}
WIDTHS = (1, 7, 8, 9, 300, 777, 12288, 12290, 24576)
HIDDEN = (1, 16, 64, 500, 512)


def column_range(i, ctas, n):
    """Columns [c0, c1) of CTA i of ``ctas`` along N, as csrc/decode_mse.cu's
    ``cta_cols`` computes them: 8-column blocks split evenly, the last cut
    at N."""
    blocks = -(-n // 8)
    return i * blocks // ctas * 8, min(n, (i + 1) * blocks // ctas * 8)


def columns_once(n, ctas, most_blocks):
    """The CTAs' column ranges tile [0, N) in order, each at most
    ``most_blocks`` 8-column blocks."""
    ranges = [column_range(i, ctas, n) for i in range(ctas)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(0 <= c1 - c0 <= 8 * most_blocks for c0, c1 in ranges)
    assert all(c0 % 8 == 0 for c0, _ in ranges)


def row_tiles_once(m, rows, groups):
    """Row group y walks tiles y, y + groups, ...: every tile exactly once."""
    tiles = -(-m // rows)
    walked = sorted(t for y in range(groups) for t in range(y, tiles, groups))
    assert walked == list(range(tiles))


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("n", WIDTHS)
def test_every_row_and_column_is_covered_once(card, n):
    sms, slots = CARDS[card]
    seen = set()
    for m in range(1, 4097):
        g = decode_geometry(m, n, 512, sms, slots)
        for split in ((g.fwd_ctas, FWD_BLOCKS), (g.dh_cluster * g.dh_clusters, DH_BLOCKS),
                      (g.dw_ctas, DW_BLOCKS)):
            if split not in seen:
                columns_once(n, *split)
                seen.add(split)
        row_tiles_once(m, FWD_ROWS, g.fwd_row_groups)
        row_tiles_once(m, DH_ROWS, g.dh_row_groups)
        assert 1 <= g.fwd_row_groups <= -(-m // FWD_ROWS)
        assert 1 <= g.dh_row_groups <= -(-m // DH_ROWS)


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("k", HIDDEN)
def test_clusters_are_portable_and_fill_one_wave_where_they_can(card, k):
    sms, slots = CARDS[card]
    for n in WIDTHS:
        for m in (1, 16, 37, 128, 129, 512, 1000, 4096):
            g = decode_geometry(m, n, k, sms, slots)
            assert 1 <= g.dh_cluster <= MAX_CLUSTER
            assert g.dh_cluster <= max(1, -(-(-(-n // 8)) // DH_BLOCKS))
            need = -(-(-(-n // 8)) // DH_BLOCKS)
            assert g.dh_clusters == -(-need // g.dh_cluster)
            fits = [c for c in range(1, min(MAX_CLUSTER, need) + 1)
                    if -(-need // c) <= slots(k, c)]
            # the largest cluster whose clusters the card holds at once
            assert g.dh_cluster == (max(fits) if fits else min(MAX_CLUSTER, need))
            if fits:
                assert g.dh_clusters * g.dh_row_groups <= slots(k, g.dh_cluster)
            if g.fwd_ctas <= sms:
                assert g.fwd_ctas * g.fwd_row_groups <= sms


def test_the_fast_step_is_one_wave_on_an_h100():
    """At N = 12288, K = 512 on 132 SMs: 128 forward and dW CTAs of 96
    columns, dh in 14 clusters of 8 (15 fit at once), so 14 partials of
    [M, K] fp32 (3.7 MB at M = 128) reach the second pass, at every M."""
    for m in (1, 32, 128, 512, 4096):
        g = decode_geometry(m, 12288, 512, 132, h100_slots)
        assert g == DecodeGeometry(fwd_ctas=128, fwd_row_groups=1, dh_cluster=8,
                                   dh_clusters=14, dh_row_groups=1, dw_ctas=128)
    assert 14 * 128 * 512 * 4 == 3_670_016


def test_a_narrow_decoder_is_one_cluster_with_row_groups():
    """N = 300 (38 blocks) needs 3 dh CTAs: one cluster of 3, which writes dh
    itself (no workspace); the spare slots go to row groups."""
    g = decode_geometry(37, 300, 64, 132, h100_slots)
    assert g == DecodeGeometry(fwd_ctas=4, fwd_row_groups=1, dh_cluster=3, dh_clusters=1,
                               dh_row_groups=2, dw_ctas=4)
    assert decode_geometry(1000, 300, 64, 132, h100_slots).fwd_row_groups == 16


def test_no_cluster_fits_falls_back_to_eight():
    g = decode_geometry(128, 12288, 512, 16, even_slots(16))
    assert (g.dh_cluster, g.dh_clusters) == (8, 14)


@pytest.mark.parametrize("m,n,k,sms", [(0, 8, 8, 132), (8, 0, 8, 132), (8, 8, 0, 132),
                                       (8, 8, 513, 132), (8, 8, 8, 0)])
def test_bad_shapes_raise(m, n, k, sms):
    with pytest.raises(ValueError):
        decode_geometry(m, n, k, sms, h100_slots)
