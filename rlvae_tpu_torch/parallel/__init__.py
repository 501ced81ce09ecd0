"""Parallelism over ``torch.distributed``: the data x model process mesh,
the centroid-sharded (expert-parallel) HMC terms, G^{-1}, its Cholesky
factor and the manifold-HMC prior chain (``python -m
rlvae_tpu_torch.parallel.ep_verify`` runs them across processes), and data
parallelism with tensor parallelism over the model axis: the layouts
(:mod:`.sharding`), the per-rank staging (:mod:`.multihost`), the counted
collectives and their audit (:mod:`.collectives`, :mod:`.comm_audit`) and
the launcher (:mod:`.launch`; ``python -m rlvae_tpu_torch.parallel.dp_verify``
checks the data-parallel train step across processes)."""

from rlvae_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    resolve_num_devices,
)
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
from rlvae_tpu_torch.parallel.multihost import host_epoch_perm, usable_local_rows
from rlvae_tpu_torch.parallel.sharding import (
    TP_MIN_PARAM_SIZE,
    pad_to_devices,
    param_shardings,
    replicate,
    shard_batch,
    shard_params,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "TP_MIN_PARAM_SIZE", "all_reduce_sum",
    "chol_g_inv_sharded", "create_mesh", "g_inv_sharded", "hmc_terms_sharded",
    "host_epoch_perm", "local_rows", "pad_metric", "pad_to_devices", "param_shardings",
    "replicate", "resolve_num_devices", "sample_prior_hmc_sharded", "shard_batch",
    "shard_metric", "shard_params", "usable_local_rows",
]
