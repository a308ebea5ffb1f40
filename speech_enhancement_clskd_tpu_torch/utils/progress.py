"""Console progress bar with ETA (reference ``Bar``, tools_for_model.py:744-812).

The port's copy of ``speech_enhancement_clskd_tpu/utils/progress.py``.

Wraps any sized iterable of batches; prints ``idx/total: [====>....] - ETA``.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator, Optional


class Bar:
    DISPLAY_LENGTH = 50

    def __init__(self, iterable: Iterable, total: Optional[int] = None,
                 batch_size: int = 1, out=None):
        import sys

        self.iterable = iterable
        self.total = total if total is not None else len(iterable)  # type: ignore
        self.batch_size = batch_size
        self.out = out or sys.stdout

    def __len__(self) -> int:
        return self.total

    def __iter__(self) -> Iterator:
        start = time.time()
        for idx, item in enumerate(self.iterable):
            yield item
            done = idx + 1
            rate = done / self.total
            elapsed = time.time() - start
            eta = elapsed / done * (self.total - done)
            n = int(rate * self.DISPLAY_LENGTH)
            bar = ("=" * n + ">").ljust(self.DISPLAY_LENGTH, ".")
            self.out.write(
                f"\r{done * self.batch_size}/{self.total * self.batch_size}: "
                f"[{bar}] - ETA {eta:.1f}s"
            )
            self.out.flush()
        self.out.write("\n")
