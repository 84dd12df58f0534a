"""Epoch samplers (a copy of ``ipoke_tpu/data/samplers.py``; reference
``data/samplers.py``).

``FixedLengthSampler`` (ref ``:40-79``): shuffled (optionally object-weighted)
index stream with a per-epoch random subset replaced by ``-1`` — the zero-poke
ids — at rate ``1/zero_poke_amount``.  Pure numpy with an explicit Generator.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


class FixedLengthSampler:
    def __init__(
        self,
        dataset_len: int,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        weights: Optional[np.ndarray] = None,
        zero_poke: bool = False,
        zero_poke_amount: Optional[int] = None,
        seed: int = 0,
    ):
        self.n = dataset_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.weights = None
        if weights is not None:
            w = np.asarray(weights, np.float64)
            self.weights = w / w.sum()
        self.zero_poke = zero_poke
        self.zero_poke_amount = zero_poke_amount
        if zero_poke:
            assert zero_poke_amount is not None
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng((self.seed, self.epoch))
        if self.shuffle:
            if self.weights is not None:
                order = rng.choice(self.n, size=self.n, p=self.weights)
            else:
                order = rng.permutation(self.n)
        else:
            order = np.arange(self.n)

        if self.zero_poke:
            zero_ids = set(
                rng.choice(self.n, size=int(self.n / self.zero_poke_amount),
                           replace=False).tolist()
            )
        else:
            zero_ids = set()

        batch = []
        for idx in order:
            batch.append(-1 if int(idx) in zero_ids else int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch


class SequenceSampler:
    """Batches of ``(index, lag)`` with ONE lag sampled per batch from the
    dataset's ``valid_lags`` (reference ``SequenceSampler``, samplers.py:7-37
    — dormant: the live experiments all use FixedLengthSampler)."""

    def __init__(self, dataset_len: int, valid_lags, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0):
        self.n = dataset_len
        self.valid_lags = list(valid_lags)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch, 1))
        order = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        lag = int(rng.choice(self.valid_lags))
        batch = []
        for idx in order:
            batch.append((int(idx), lag))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
                lag = int(rng.choice(self.valid_lags))
        if batch and not self.drop_last:
            yield batch


class SequenceLengthSampler:
    """Variable-sequence-length batches: one ``n_frames`` drawn per batch
    (optionally zero-poke == -1 with a separate actual length), weighted by
    ``len_p`` incl. the reference's zeropoke/longest-seq upweighting
    (reference ``SequenceLengthSampler``, samplers.py:83-141 — dormant).

    Yields batches of ``(index, n_frames)``; ``n_frames == -1`` marks a
    zero-poke element whose actual rollout length is resampled."""

    def __init__(self, dataset_len: int, max_frames: int, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 n_frames: Optional[int] = None, zero_poke: bool = False,
                 zeropoke_weight: float = 1.0,
                 longest_seq_weight: Optional[float] = None,
                 train: bool = True, seed: int = 0):
        self.n = dataset_len
        self.max_frames = max_frames
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.n_frames = n_frames
        self.start = -1 if zero_poke else 0
        if zero_poke and train:
            len_p = np.asarray([zeropoke_weight] + [1.0] * max_frames)
        elif zero_poke:
            len_p = np.asarray([1.0] * (max_frames + 1))
        else:
            len_p = np.asarray([1.0] * max_frames)
        if longest_seq_weight is not None and train:
            len_p[-1] = longest_seq_weight
            if zero_poke:
                len_p[0] = longest_seq_weight / 2
        self.len_p = len_p / len_p.sum()
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def _draw(self, rng, last):
        """Next batch length: weighted draw when shuffling, else cycle
        start..max_frames-1 wrapping (reference samplers.py:136-141)."""
        if self.n_frames is not None:
            return int(self.n_frames)
        if self.shuffle:
            return int(rng.choice(
                np.arange(self.start, self.max_frames), p=self.len_p))
        return last + 1 if last < self.max_frames - 1 else self.start

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch, 2))
        order = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        # first batch: fixed n_frames always wins (reference :130 overrides
        # every element); non-shuffle cycling starts at self.start
        nf = self._draw(rng, self.start - 1)
        batch = []
        for idx in order:
            batch.append((int(idx), nf))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
                nf = self._draw(rng, nf)
        if batch and not self.drop_last:
            yield batch
