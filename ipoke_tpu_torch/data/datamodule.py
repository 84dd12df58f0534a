"""Data module: datasets + samplers + threaded host loader with device
prefetch (counterpart of ``ipoke_tpu/data/datamodule.py``).

``collate``, ``StaticDataModule`` and ``ThreadedLoader`` are the JAX
package's: a thread pool (cv2/numpy release the GIL for IO and resize)
fills a depth-2 queue of collated numpy batches, each item drawn from its
own ``np.random.Generator((seed, batch, item))``, so both packages yield the
same bytes.  ``device_prefetch`` replaces ``jax.device_put``: on a CUDA
device each batch goes into pinned host tensors and is copied
``non_blocking`` on a side stream, up to ``depth`` batches in flight; the
consumer's stream waits on each copy's event before the batch is handed
out.  The device tensors are allocated on the side stream and used and
freed on the consumer's, so each one records the consumer's stream
(``record_stream``): the caching allocator then reuses its memory only once
the consumer's work on it is done.  On the CPU there is no pinning and no
stream: the numpy arrays are wrapped as they are.  float64 arrays (the
geometric augmentation's rotated flow) arrive as float32, as
``jnp.asarray`` gives them to the JAX package.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from .datasets import IperDataset, get_dataset
from .samplers import FixedLengthSampler


def collate(items) -> Dict[str, np.ndarray]:
    out = {}
    for key in items[0]:
        out[key] = np.stack([it[key] for it in items], axis=0)
    return out


class StaticDataModule:
    """Builds train/val/test datasets per the reference's config contract."""

    def __init__(self, config: dict, datakeys: Sequence[str],
                 debug: bool = False, meta=None, data_root=None):
        self.config = config
        self.datakeys = list(datakeys)
        self.batch_size = config["batch_size"]
        self.n_workers = int(config.get("n_workers", 4))
        self.zero_poke = bool(config.get("zero_poke", False))
        self.seed = int(config.get("seed", 0))
        dset_cls = get_dataset(config["dataset"])
        kw = dict(meta=meta, data_root=data_root)
        self.dset_train = dset_cls(config, self.datakeys, train=True, **kw)
        val_keys = list(self.datakeys)
        if dset_cls is IperDataset and "keypoints" in getattr(
            self.dset_train, "datadict", {}
        ):
            val_keys += ["keypoints_rel", "keypoints_abs"]
        self.dset_val = dset_cls(config, val_keys, train=False, **kw)
        self.dset_test = self.dset_val

    def _loader(self, dset, batch_size, train: bool, epoch: int = 0,
                n_batches: Optional[int] = None):
        weights = (dset.datadict.get("weights")
                   if getattr(dset, "obj_weighting", False) else None)
        sampler = FixedLengthSampler(
            len(dset), batch_size, shuffle=True, drop_last=True,
            weights=weights,
            zero_poke=self.zero_poke and train,
            zero_poke_amount=self.config.get("zero_poke_amount", 12)
            if self.zero_poke and train else None,
            seed=self.seed + (0 if train else 7919),
        )
        sampler.set_epoch(epoch)
        return ThreadedLoader(dset, sampler, n_workers=self.n_workers,
                              seed=self.seed + epoch, n_batches=n_batches)

    def train_loader(self, epoch: int = 0, n_batches: Optional[int] = None):
        return self._loader(self.dset_train, self.batch_size, True, epoch,
                            n_batches)

    def val_loader(self, epoch: int = 0, n_batches: Optional[int] = None):
        return self._loader(self.dset_val, self.batch_size, False, epoch,
                            n_batches)

    def test_loader(self, n_batches: Optional[int] = None):
        bs = self.config.get("test_batch_size", self.batch_size)
        return self._loader(self.dset_test, bs, False, 0, n_batches)


class ThreadedLoader:
    """Iterates collated numpy batches; IO fans out over a thread pool and a
    depth-2 queue keeps the device fed."""

    def __init__(self, dataset, sampler, n_workers: int = 4, seed: int = 0,
                 n_batches: Optional[int] = None, prefetch: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.n_workers = max(1, n_workers)
        self.seed = seed
        self.n_batches = n_batches
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.sampler)
        return min(n, self.n_batches) if self.n_batches else n

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.n_workers) as pool:
                    for bi, batch_ids in enumerate(self.sampler):
                        if self.n_batches is not None and bi >= self.n_batches:
                            break
                        if stop.is_set():
                            break
                        rngs = [
                            np.random.default_rng((self.seed, bi, j))
                            for j in range(len(batch_ids))
                        ]
                        items = list(pool.map(
                            lambda a: self.dataset.get_item(a[0], a[1]),
                            zip(batch_ids, rngs),
                        ))
                        q.put(collate(items))
            except Exception as e:  # re-raised in the consumer
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            # unblock a producer waiting on the full queue, then let it end
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass


def _tensor(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.float() if t.dtype == torch.float64 else t


def device_prefetch(it, device, depth: int = 2):
    """Batches of ``it`` (dicts of numpy arrays) as tensors on ``device``,
    with up to ``depth`` host-to-device copies in flight on a side CUDA
    stream (see the module docstring).  On the CPU: ``torch.from_numpy``."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in it:
            yield {k: _tensor(v) for k, v in batch.items()}
        return
    side = torch.cuda.Stream(device)
    pending = collections.deque()

    def hand_out():
        # the pinned host tensors are held until their copy is waited on
        dev, event, _host = pending.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for t in dev.values():
            t.record_stream(consumer)
        return dev

    for batch in it:
        host = {k: _tensor(v).pin_memory() for k, v in batch.items()}
        # the copies write fresh allocations of the side stream only, so the
        # side stream needs no wait on the consumer
        with torch.cuda.stream(side):
            dev = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(side)
        pending.append((dev, event, host))
        if len(pending) >= depth:
            yield hand_out()
    while pending:
        yield hand_out()
