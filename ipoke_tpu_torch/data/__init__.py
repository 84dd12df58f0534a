"""Data layer (counterpart of ``ipoke_tpu/data``): the on-disk datasets,
poke simulation, samplers, the threaded loader with CUDA-stream prefetch,
the synthetic tree and synthetic in-memory batches."""

from .datamodule import StaticDataModule, ThreadedLoader, collate, device_prefetch
from .datasets import (
    Human36mDataset,
    IperDataset,
    PlantDataset,
    TaichiDataset,
    VideoDataset,
    get_dataset,
)
from .poke import FlowError, simulate_poke
from .samplers import FixedLengthSampler
from .synthetic import make_batch
