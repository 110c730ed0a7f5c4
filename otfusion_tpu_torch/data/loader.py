"""Batching (port of ``otfusion_tpu.data.loader``: the unimodal ``Loader``
and the paired ``MultimodalLoader``, single host).

A thread pool loads and preprocesses volumes into an LRU cache; ``prefetch``
assembles the next batch on a background thread while the device computes.
Batch order, the final partial batch, and the augmentation RNG keyed on
(seed, epoch, sample index, modality) are the JAX package's, so both loaders
yield identical batches. Batches are CPU tensors: volumes (B, D, H, W, 1) in
the feed dtype (bf16 when the model computes in bf16 — the stem casts its
input to bf16 either way), labels int64.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import random
import threading
from collections import OrderedDict
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from otfusion_tpu_torch.data.preprocess import load_volume


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Double-buffered iteration: a background thread keeps up to
    ``depth`` items ready while the consumer works on the current one."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    errors: list[BaseException] = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer thread
            errors.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if errors:
                raise errors[0]
            return
        yield item


class _VolumeCache:
    """LRU cache of preprocessed volumes with thread-pool loading."""

    def __init__(self, target_shape, max_items: int = 2048,
                 num_workers: int = 8):
        self.target_shape = tuple(target_shape)
        self.max_items = max_items
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._pool = cf.ThreadPoolExecutor(max_workers=max(1, num_workers))

    def get_many(self, paths: Sequence[str]) -> List[np.ndarray]:
        missing = list({p for p in paths if p not in self._cache})
        loaded: Dict[str, np.ndarray] = {}
        if missing:
            results = self._pool.map(
                lambda p: load_volume(p, self.target_shape), missing
            )
            loaded = dict(zip(missing, results))
        out = []
        for p in paths:
            if p in loaded:
                out.append(loaded[p])
            else:
                self._cache.move_to_end(p)
                out.append(self._cache[p])
        for p, vol in loaded.items():
            self._cache[p] = vol
        while len(self._cache) > self.max_items:
            self._cache.popitem(last=False)
        return out


def _augment_np(vol: np.ndarray, rng: random.Random) -> np.ndarray:
    """Random axis flips, p=0.5 per axis."""
    for axis in range(3):
        if rng.random() < 0.5:
            vol = np.flip(vol, axis=axis)
    return np.ascontiguousarray(vol)


def _augment_rng(seed: int, epoch: int, sample_idx: int,
                 stream: int = 0) -> random.Random:
    """Fresh RNG per (seed, epoch, sample, modality stream), independent of
    the shuffle stream."""
    return random.Random(
        (seed * 2654435761 + epoch * 97003 + sample_idx * 31 + stream)
        % (2 ** 63)
    )


def feed_dtype_for(compute_dtype) -> torch.dtype:
    """Volumes ship in bf16 when the model computes in bf16 (the stem
    casts to bf16 anyway, so the values are the same and the host-to-device
    bytes halve), else in fp32."""
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32


def _stack(vols: List[np.ndarray], dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.stack(vols).astype(np.float32,
                                                  copy=False)).to(dtype)


class Loader:
    """Unimodal loader over (path, label) samples; yields (volumes,
    labels)."""

    columns = 1  # volume paths at the head of each sample

    def __init__(
        self,
        samples: Sequence[tuple],
        target_shape,
        batch_size: int,
        shuffle: bool = False,
        augment: bool = False,
        seed: int = 42,
        cache: _VolumeCache | None = None,
        feed_dtype: torch.dtype = torch.float32,
    ):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.seed = seed
        self.rng = random.Random(seed)  # shuffle stream only
        self.cache = cache or _VolumeCache(target_shape)
        self.feed_dtype = feed_dtype
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.samples) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        self._epoch += 1
        order = list(range(len(self.samples)))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start : start + bs]
            labels = torch.tensor([self.samples[i][-1] for i in idx],
                                  dtype=torch.int64)
            yield (*self._volumes(idx), labels)

    def _volumes(self, idx: List[int]) -> Tuple[torch.Tensor, ...]:
        """The ``columns`` volume columns of the samples ``idx``, loaded in
        one pool pass, column ``c`` augmented with flip stream ``c``,
        stacked."""
        n = len(idx)
        vols = self.cache.get_many([self.samples[i][c]
                                    for c in range(self.columns)
                                    for i in idx])
        out = []
        for c in range(self.columns):
            col = vols[c * n:(c + 1) * n]
            if self.augment:
                col = [
                    _augment_np(v, _augment_rng(self.seed, self._epoch, i, c))
                    for v, i in zip(col, idx)
                ]
            out.append(_stack(col, self.feed_dtype))
        return tuple(out)


class MultimodalLoader(Loader):
    """Paired loader over (mri_path, pet_path, label) samples; yields
    (mri, pet, labels)."""

    columns = 2
