"""Cyclic sequence data: synthetic generator, dataset and data module."""

from rlvae_tpu_torch.data.cyclic import (
    CYCLIC_SPRITES,
    CyclicDataModule,
    CyclicSequenceDataset,
    batch_iterator,
)
from rlvae_tpu_torch.data.synth import generate_cyclic_sequences

__all__ = [
    "CYCLIC_SPRITES", "CyclicDataModule", "CyclicSequenceDataset", "batch_iterator",
    "generate_cyclic_sequences",
]
