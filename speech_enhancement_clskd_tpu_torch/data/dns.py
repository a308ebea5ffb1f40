"""DNS-challenge dataset (reference surface: asteroid ``DNSDataset``,
imported by distill.py:14-25 as the alternative corpus to LibriMix —
SURVEY.md section 2.2).

Two on-disk layouts are accepted:

1. The standard DNS-challenge synthesized layout::

       root/noisy/<anything>_fileid_<N>.wav
       root/clean/clean_fileid_<N>.wav

   Pairs are matched on the trailing ``fileid_<N>``.

2. A JSON manifest (``file_infos.json`` in the directory, or a path to any
   ``.json`` file): a list of ``{"mix": ..., "clean": ...[, "noise": ...]}``
   entries (paths relative to the manifest's directory or absolute).

Returns ``(mix [T], sources [1, T])`` items — the same item contract as
``LibriMixDataset``, so ``make_loader`` / the Trainer consume it unchanged.

The port's own copy of ``speech_enhancement_clskd_tpu/data/dns.py`` (numpy
only): the same directory and seed give the same items, and the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Tuple

import numpy as np

from .wav import read_wav

_FILEID_RE = re.compile(r"fileid_(\d+)\.wav$")


def _index_by_fileid(d: str) -> dict:
    out = {}
    for name in os.listdir(d):
        m = _FILEID_RE.search(name)
        if m:
            out[m.group(1)] = os.path.join(d, name)
    return out


class DNSDataset:
    def __init__(
        self,
        root: str,
        sample_rate: int = 16000,
        segment: Optional[float] = 3.0,
        return_id: bool = False,
        seed: int = 0,
    ):
        self.sample_rate = sample_rate
        self.segment = segment
        self.return_id = return_id
        self.seed = seed
        self.pairs: List[Tuple[str, str, str]] = []  # (id, mix, clean)

        manifest = None
        if os.path.isfile(root) and root.endswith(".json"):
            manifest = root
        elif os.path.isfile(os.path.join(root, "file_infos.json")):
            manifest = os.path.join(root, "file_infos.json")

        if manifest is not None:
            base = os.path.dirname(os.path.abspath(manifest))
            with open(manifest) as f:
                entries = json.load(f)
            for i, e in enumerate(entries):
                mix = e["mix"] if os.path.isabs(e["mix"]) else os.path.join(base, e["mix"])
                clean = e["clean"] if os.path.isabs(e["clean"]) else os.path.join(base, e["clean"])
                self.pairs.append((str(e.get("id", i)), mix, clean))
        else:
            noisy_dir = os.path.join(root, "noisy")
            clean_dir = os.path.join(root, "clean")
            if not (os.path.isdir(noisy_dir) and os.path.isdir(clean_dir)):
                raise FileNotFoundError(
                    f"{root}: expected noisy/ + clean/ dirs or a JSON manifest"
                )
            noisy = _index_by_fileid(noisy_dir)
            clean = _index_by_fileid(clean_dir)
            for fid in sorted(noisy.keys() & clean.keys(), key=int):
                self.pairs.append((fid, noisy[fid], clean[fid]))
        if not self.pairs:
            raise ValueError(f"{root}: no (noisy, clean) pairs found")

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int):
        fid, mix_path, clean_path = self.pairs[idx]
        mix, sr = read_wav(mix_path)
        if sr != self.sample_rate:
            raise ValueError(f"sample-rate mismatch {sr} != {self.sample_rate}")
        clean, sr_c = read_wav(clean_path)
        if sr_c != self.sample_rate:
            raise ValueError(
                f"clean sample-rate mismatch {sr_c} != {self.sample_rate}"
            )
        n = min(len(mix), len(clean))
        mix, clean = mix[:n], clean[:n]
        if self.segment is not None:
            seg = int(self.segment * self.sample_rate)
            if n < seg:  # pad short utterances (DNS clips are fixed-length
                # in the official corpus; tolerate ragged custom data)
                pad = seg - n
                mix = np.pad(mix, (0, pad))
                clean = np.pad(clean, (0, pad))
            else:
                rng = np.random.default_rng((self.seed, idx))
                start = int(rng.integers(0, n - seg + 1))
                mix = mix[start : start + seg]
                clean = clean[start : start + seg]
        sources = clean[None].astype(np.float32)
        if self.return_id:
            return mix.astype(np.float32), sources, fid
        return mix.astype(np.float32), sources
