"""Research models on the port's paths: ``LVAE_IAF``, ``LVAE_GUGUS`` (every
variant), ``RIEM``, ``VAMP`` and ``GPVAE``, ports of
``rlvae_tpu/models/research/`` (``LLDM`` is not ported yet: ROADMAP A7c)."""

from rlvae_tpu_torch.models.research._sampled import SampledMetric
from rlvae_tpu_torch.models.research.gpvae import GPVAE, gp_kernel
from rlvae_tpu_torch.models.research.gugus import LVAE_GUGUS
from rlvae_tpu_torch.models.research.lvae_iaf import LVAE_IAF
from rlvae_tpu_torch.models.research.riem import RIEM
from rlvae_tpu_torch.models.research.vamp import VAMP

__all__ = ["GPVAE", "LVAE_GUGUS", "LVAE_IAF", "RIEM", "SampledMetric", "VAMP", "gp_kernel"]
