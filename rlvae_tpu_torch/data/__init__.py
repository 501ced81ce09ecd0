"""Cyclic sequence data: synthetic generator, dataset and data module (the
native batch loader, :mod:`rlvae_tpu_torch.data.native_loader`, behind its
training batches), the ``.pt`` converters (:mod:`rlvae_tpu_torch.data.convert`)
and the research models' missing-data masks."""

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
from rlvae_tpu_torch.data.synth import generate_cyclic_sequences, write_synthetic_dataset

__all__ = [
    "CYCLIC_SPRITES", "CyclicDataModule", "CyclicSequenceDataset", "batch_iterator",
    "create_and_save_masks", "generate_cyclic_sequences", "load_masks", "make_batched_masks",
    "make_pixel_masks", "write_synthetic_dataset",
]
