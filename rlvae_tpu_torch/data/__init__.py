"""Cyclic sequence data: synthetic generator, dataset and data module, and the
research models' missing-data masks."""

from rlvae_tpu_torch.data.cyclic import (
    CYCLIC_SPRITES,
    CyclicDataModule,
    CyclicSequenceDataset,
    batch_iterator,
)
from rlvae_tpu_torch.data.masks import (
    create_and_save_masks,
    load_masks,
    make_batched_masks,
    make_pixel_masks,
)
from rlvae_tpu_torch.data.synth import generate_cyclic_sequences

__all__ = [
    "CYCLIC_SPRITES", "CyclicDataModule", "CyclicSequenceDataset", "batch_iterator",
    "create_and_save_masks", "generate_cyclic_sequences", "load_masks", "make_batched_masks",
    "make_pixel_masks",
]
