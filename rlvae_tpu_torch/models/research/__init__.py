"""Research models on the port's paths: ``LVAE_IAF``, ``LVAE_GUGUS`` (every
variant), ``RIEM``, ``VAMP``, ``GPVAE`` and ``LLDM`` (with its latent
diffusion, DDIM sampler and sampled observation metric), ports of
``rlvae_tpu/models/research/``."""

from rlvae_tpu_torch.models.research.gpvae import GPVAE, gp_kernel
from rlvae_tpu_torch.models.research.gugus import LVAE_GUGUS
from rlvae_tpu_torch.models.research.lldm import (
    LLDM,
    DDIMSampler,
    LatentDiffusion,
    SampledMetric,
    pretrain_latent_diffusion,
)
from rlvae_tpu_torch.models.research.lvae_iaf import LVAE_IAF
from rlvae_tpu_torch.models.research.riem import RIEM
from rlvae_tpu_torch.models.research.vamp import VAMP

__all__ = ["DDIMSampler", "GPVAE", "LLDM", "LVAE_GUGUS", "LVAE_IAF", "LatentDiffusion", "RIEM",
           "SampledMetric", "VAMP", "gp_kernel", "pretrain_latent_diffusion"]
