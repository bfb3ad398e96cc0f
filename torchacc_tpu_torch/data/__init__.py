"""The input pipeline (the port of torchacc_tpu/data, core only):
sequence packing, bucketing, ``PackedDataset`` and the ``AsyncLoader``.
The streaming and object-store sources wait for ROADMAP A13."""

from torchacc_tpu_torch.data.async_loader import AsyncLoader
from torchacc_tpu_torch.data.bucketing import closest_bucket, pad_batch
from torchacc_tpu_torch.data.dataset import DataLoaderError, PackedDataset
from torchacc_tpu_torch.data.packing import pack_sequences

__all__ = ["AsyncLoader", "closest_bucket", "pad_batch", "PackedDataset",
           "DataLoaderError", "pack_sequences"]
