"""LibriMix CSV-manifest dataset (reference: asteroid LibriMix behaviour,
SURVEY.md section 1 L1; manifests data/wav16k/{min,max}/{dev,test}/*.csv with
columns mixture_ID,mixture_path,source_1_path[,source_2_path][,noise_path],length).

Behaviour parity with the reference configuration (distill.py:206-229):
- task 'enh_single': mixture = mix_single, targets = [source_1]
- fixed ``segment`` seconds: utterances shorter than the segment are dropped,
  longer ones are randomly cropped (deterministic per (seed, index))
- ``segment=None``: full-length utterances, one at a time (eval mode)

The port's own copy of ``speech_enhancement_clskd_tpu/data/librimix.py``
(numpy only): the same manifest and seed give the same items, and the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

import numpy as np

from .wav import read_wav

_TASK_COLS = {
    "enh_single": ["source_1_path"],
    "enh_both": ["mixture_path"],
    "sep_clean": ["source_1_path", "source_2_path"],
    "sep_noisy": ["source_1_path", "source_2_path"],
}

_TASK_CSV = {
    "enh_single": "mixture_{split}_mix_single.csv",
    "enh_both": "mixture_{split}_mix_both.csv",
    "sep_clean": "mixture_{split}_mix_clean.csv",
    "sep_noisy": "mixture_{split}_mix_both.csv",
}


class LibriMixDataset:
    def __init__(
        self,
        csv_dir: str,
        task: str = "enh_single",
        sample_rate: int = 16000,
        n_src: int = 1,
        segment: Optional[float] = 3.0,
        return_id: bool = False,
        seed: int = 0,
    ):
        self.csv_dir = csv_dir
        self.task = task
        self.sample_rate = sample_rate
        self.n_src = n_src
        self.segment = segment
        self.return_id = return_id
        self.seed = seed
        split = os.path.basename(os.path.normpath(csv_dir))
        csv_name = _TASK_CSV[task].format(split=split)
        csv_path = os.path.join(csv_dir, csv_name)
        if not os.path.exists(csv_path):
            # fall back to any mixture csv present
            cands = [f for f in os.listdir(csv_dir) if f.endswith(".csv")]
            if not cands:
                raise FileNotFoundError(f"no manifest csv in {csv_dir}")
            csv_path = os.path.join(csv_dir, sorted(cands)[0])
        self.csv_path = csv_path
        self.rows: List[dict] = []
        min_len = int(segment * sample_rate) if segment else 0
        with open(csv_path) as f:
            for row in csv.DictReader(f):
                if int(row["length"]) >= min_len:
                    self.rows.append(row)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int):
        row = self.rows[idx]
        mix, sr = read_wav(row["mixture_path"])
        if sr != self.sample_rate:
            raise ValueError(f"sample-rate mismatch {sr} != {self.sample_rate}")
        srcs = [read_wav(row[c])[0] for c in _TASK_COLS[self.task][: self.n_src]]
        if self.segment is not None:
            seg = int(self.segment * self.sample_rate)
            rng = np.random.default_rng((self.seed, idx))
            start = int(rng.integers(0, max(len(mix) - seg, 0) + 1))
            mix = mix[start : start + seg]
            srcs = [s[start : start + seg] for s in srcs]
        sources = np.stack(srcs).astype(np.float32)
        if self.return_id:
            return mix.astype(np.float32), sources, row["mixture_ID"]
        return mix.astype(np.float32), sources
