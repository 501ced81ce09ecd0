"""The centroid-sharded (expert-parallel) metric path over
``torch.distributed``: the process mesh and the sharded HMC terms, G^{-1},
its Cholesky factor and the manifold-HMC prior chain
(``python -m rlvae_tpu_torch.parallel.ep_verify`` runs them across
processes)."""

from rlvae_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, create_mesh
from rlvae_tpu_torch.parallel.metric_parallel import (
    all_reduce_sum,
    chol_g_inv_sharded,
    g_inv_sharded,
    hmc_terms_sharded,
    local_rows,
    pad_metric,
    sample_prior_hmc_sharded,
    shard_metric,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "all_reduce_sum", "chol_g_inv_sharded", "create_mesh",
    "g_inv_sharded", "hmc_terms_sharded", "local_rows", "pad_metric",
    "sample_prior_hmc_sharded", "shard_metric",
]
