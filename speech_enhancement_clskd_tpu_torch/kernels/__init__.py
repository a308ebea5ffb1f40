"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and the input checks their wrappers share."""

from __future__ import annotations

import torch


def check_tensors(named, device: torch.device, op: str) -> None:
    """Raise unless every tensor of ``named`` (``(name, tensor)`` pairs;
    ``None`` is skipped) is float32, contiguous and on ``device``, and
    ``device`` is a CPU or CUDA device (``op`` names the caller)."""
    for name, t in named:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on CPU or CUDA tensors, not {device}")
