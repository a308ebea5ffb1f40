"""Minimal RIFF/WAVE codec (PCM16 + float32, mono/multichannel).

Replaces the reference's libsndfile dependency (eval.py:92-101 writes PCM16
mono examples) — this image has no soundfile, and PCM16 is the only format the
pipeline touches, so a small numpy codec beats a native dependency.

The port's own copy of ``speech_enhancement_clskd_tpu/data/wav.py`` (numpy
only): the same bytes give the same samples, and the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (float32 samples in [-1, 1] shaped [T] or [T, C], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_ch, rate, _, _, bits = fmt
    if audio_format == 1 and bits == 16:
        x = np.frombuffer(samples, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(samples, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(samples, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported format {audio_format}/{bits}bit")
    if n_ch > 1:
        x = x.reshape(-1, n_ch)
    return x, rate


def write_wav(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write float32 [-1,1] samples ([T] or [T, C]) as PCM16."""
    x = np.asarray(x, dtype=np.float32)
    n_ch = 1 if x.ndim == 1 else x.shape[1]
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    body = pcm.tobytes()
    byte_rate = sample_rate * n_ch * 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, n_ch, sample_rate, byte_rate,
                                 n_ch * 2, 16)
    hdr += b"data" + struct.pack("<I", len(body))
    with open(path, "wb") as f:
        f.write(hdr + body)
