"""Legacy .npy paired-waveform datasets (reference dataloader.py:38-88).

The reference's earlier DNS-challenge workflow stored (noisy, clean) pairs in
pickled .npy blobs: ``train_dataset.npy``/``validation_dataset.npy`` indexed
[idx][0]=noisy, [idx][1]=clean, and a test blob indexed [type][snr][idx].
Same access contract here, numpy-only.

The port's own copy of ``speech_enhancement_clskd_tpu/data/npy_dataset.py``
(numpy only): the same file gives the same items, and the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class WaveDataset:
    def __init__(self, path: str):
        self.data = np.load(path, allow_pickle=True)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        noisy = np.asarray(self.data[idx][0], dtype=np.float32)
        clean = np.asarray(self.data[idx][1], dtype=np.float32)
        return noisy, clean[None]


class WaveDatasetForTest(WaveDataset):
    """Test split indexed by (noise type, SNR bucket) (dataloader.py:66-88)."""

    def __init__(self, path: str, noise_type: int, snr: int):
        data = np.load(path, allow_pickle=True)
        self.data = data[noise_type][snr]
