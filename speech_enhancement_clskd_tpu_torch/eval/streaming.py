"""Streaming (chunked) DCCRN inference: the serving path.

Port of ``speech_enhancement_clskd_tpu/eval/streaming.py``.  DCCRN is causal
with a bounded receptive field in its conv stack but unbounded memory in the
LSTM, so the engine runs the model over a sliding window of
``context + chunk`` frames (plus a right guard) and emits ``chunk`` frames:

- the conv stack is exact for ``context >= 12`` frames;
- the LSTM gets ``context`` frames of warmup per chunk;
- algorithmic latency = one chunk plus the guard: the last
  ``win/hop - 1`` frames of a window still wait for iSTFT overlap-add, and
  the asteroid DCCRNet family's non-causal convs add ``2 * len(kernel_num)
  + 1`` frames more.

Each chunk is one forward of the same fixed shape on the device.  BatchNorm
runs on running statistics, so chunking does not perturb normalization.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from ..config import DCCRNConfig
from ..models.dccrn import make_model


class StreamingEnhancer:
    def __init__(
        self,
        cfg: DCCRNConfig,
        state: Mapping[str, torch.Tensor],
        device: Union[str, torch.device] = "cuda",
        chunk_frames: int = 48,
        context_frames: int = 64,
        lookahead_frames: Optional[int] = None,
    ):
        """``state`` is the model's state_dict (``utils.bridge`` makes one
        from a bundle).  ``device="cuda"`` with no GPU raises."""
        self.cfg = cfg
        self.model = make_model(cfg, device)
        self.model.load_state_dict(state)
        self.device = next(self.model.parameters()).device
        self.hop = cfg.stft.hop
        self.win = cfg.stft.win_len
        self.chunk = chunk_frames
        self.context = context_frames
        self.chunk_samples = chunk_frames * self.hop
        if lookahead_frames is None:
            lookahead_frames = self.win // self.hop - 1
            if cfg.family == "dccrnet":
                # its convs look one frame ahead per encoder layer, mirrored
                # in the decoder
                lookahead_frames += 2 * len(cfg.kernel_num) + 1
        self.guard = lookahead_frames * self.hop
        self.window_samples = (context_frames + chunk_frames) * self.hop + self.guard

    @torch.inference_mode()
    def step(self, window: torch.Tensor) -> torch.Tensor:
        """One chunk: [B, window_samples] on the device -> [B, chunk_samples]."""
        out = self.model(window, training=False)
        return out.wav[:, -(self.chunk_samples + self.guard): -self.guard]

    def stream(self, wav: np.ndarray) -> np.ndarray:
        """Enhance [T] or [B, T] audio chunk by chunk; returns the same shape."""
        squeeze = wav.ndim == 1
        x = np.atleast_2d(np.asarray(wav, np.float32))
        B, T = x.shape
        pad_t = (-T) % self.chunk_samples
        # left prime = context, right flush = tail pad + lookahead guard
        xp = np.pad(x, ((0, 0), (self.context * self.hop, pad_t + self.guard)))
        xd = torch.from_numpy(xp).to(self.device)
        n_chunks = (T + pad_t) // self.chunk_samples
        chunks = []
        for i in range(n_chunks):
            start = i * self.chunk_samples
            chunks.append(self.step(xd[:, start: start + self.window_samples]))
        out = torch.cat(chunks, dim=1)[:, :T].cpu().numpy()
        return out[0] if squeeze else out

    @property
    def latency_samples(self) -> int:
        return self.chunk_samples + self.guard

    @property
    def latency_ms(self) -> float:
        return 1000.0 * self.latency_samples / self.cfg.stft.sample_rate
