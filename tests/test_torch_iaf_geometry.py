"""The IAF-chain kernels' launch geometry, on the CPU.

``chain_geometry`` gives the R and cluster count of the rule of the
launchers in ``csrc/iaf_chain.cu`` and ``csrc/iaf_chain_bwd.cu``
(``cluster_rows`` in ``csrc/iaf_cluster.cuh``); the backward's workspace
takes its first dimension from it.  The card test
``test_geometry_matches_the_launchers`` (``tests/test_torch_kernels.py``)
holds it to the launchers' own answer.  Here: every batch from 1 to 1000
splits into clusters that cover each row once, within the kernels' limits,
and B <= 64 fits in one wave of the H100's 132 SMs.
"""

import pytest
import torch

from rlvae_tpu_torch.ops import iaf_kernels as ik

H100_SMS = 132


def test_every_row_belongs_to_one_cluster():
    for b in range(1, 1001):
        g = ik.chain_geometry(b)
        assert g.rows in (1, 2, 4, 8) and g.ctas == ik.CLUSTER_CTAS == 8
        # cluster k owns rows [k*R, (k+1)*R) below B: each row once, no empty cluster
        owners = torch.arange(b) // g.rows
        assert torch.equal(torch.bincount(owners, minlength=g.clusters).clamp(max=1),
                           torch.ones(g.clusters, dtype=torch.long))
        assert (g.clusters - 1) * g.rows < b <= g.clusters * g.rows
        if b <= 64:
            assert g.clusters * g.ctas <= H100_SMS
        else:
            assert g.rows == ik.MAX_CLUSTER_ROWS


def test_rows_are_the_fewest_that_fit_one_wave():
    """R is the smallest power of two that keeps the grid to 8 clusters:
    halving it would need more clusters than one wave holds."""
    for b in range(1, 65):
        g = ik.chain_geometry(b)
        assert g.clusters <= ik.CLUSTERS_PER_WAVE
        if g.rows > 1:
            assert -(-b // (g.rows // 2)) > ik.CLUSTERS_PER_WAVE


@pytest.mark.parametrize("b", [1, 7, 16, 37, 64, 300])
def test_workspace_has_one_slot_per_cluster(b):
    nt, nb, d, h, nh = 7, 2, 16, 256, 3
    weights = (torch.zeros(nt, nb, d, h), torch.zeros(nt, nb, h),
               torch.zeros(nt, nb, nh - 1, h, h), torch.zeros(nt, nb, nh - 1, h),
               torch.zeros(nt, nb, h, 2 * d), torch.zeros(nt, nb, 2 * d))
    parts = ik.bwd_workspace(b, weights)
    clusters = ik.chain_geometry(b).clusters
    assert [tuple(p.shape) for p in parts] == [(clusters, *w.shape) for w in weights]
