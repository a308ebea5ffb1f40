"""Batched, shuffled, host-side data loader with background prefetch.

Replaces the reference's torch DataLoader usage (dataloader.py:13-28: batch 32,
shuffle train, drop_last, num_workers=0).  Host-side numpy batching with a
double-buffered background thread; device transfer happens in the trainer so
sharding stays in one place.

The port's own copy of ``speech_enhancement_clskd_tpu/data/loader.py``
(numpy only): the same ``(seed, epoch)`` gives the same batch order, and the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


class make_loader:
    """Iterable over (mixture [B, T], sources [B, n_src, T]) numpy batches."""

    def __init__(
        self,
        dataset,
        batch_size: int = 32,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx

    def _produce(self, q: "queue.Queue") -> None:
        order = self._index_order()
        n_batches = len(self)
        for b in range(n_batches):
            sel = order[b * self.batch_size : (b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in sel]
            mix = np.stack([it[0] for it in items])
            src = np.stack([it[1] for it in items])
            q.put((mix, src))
        q.put(None)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item
        self.epoch += 1
