"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; the input checks their wrappers share (float32, or bfloat16 for
the kernels with a bf16 instantiation: K3f/K3w, K4f/K4b, K5f/K5b and K2;
the LSTM kernels K1f/K1b take float32 alone), and the measure that holds a
bf16 kernel to its plain version (``bf16_check``)."""

from __future__ import annotations

from typing import Optional

import torch


def check_tensors(named, device: torch.device, op: str,
                  dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor of ``named`` (``(name, tensor)`` pairs;
    ``None`` is skipped) is of ``dtype`` (float32 unless the wrapper has a
    bf16 instantiation and was given bf16), contiguous and on ``device``, and
    ``device`` is a CPU or CUDA device (``op`` names the caller)."""
    for name, t in named:
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on CPU or CUDA tensors, not {device}")


def float_dtype(t: torch.Tensor, op: str) -> torch.dtype:
    """The dtype a wrapper with a bf16 instantiation runs in: ``t``'s, if
    float32 or bfloat16 (``op`` names the caller)."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{op} takes float32 or bfloat16 tensors, got {t.dtype}")
    return t.dtype


def _bf16_spacing(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16's spacing at the larger magnitude of each pair: 2^(e - 7) for
    magnitudes in [2^e, 2^(e + 1)), the smallest normal spacing below."""
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# the rounding a bf16 kernel and its plain version may differ by beyond one
# bf16 spacing, as a share of the magnitudes summed into an element: a sum of
# exact products (K3f) or of float32 terms (K4b's dx and dres) in another
# order, four float32 roundings of the terms' magnitudes; K4f's blend, one bf16
# spacing of z (up to 2^-7 of z) carried through each product, and each
# side's rounding of the products (2^-9 each)
SUM_REL = 2.0 ** -22
BLEND_REL = 2.0 ** -6


def bf16_check(got: torch.Tensor, want: torch.Tensor, scale: Optional[torch.Tensor] = None,
               rel: float = 0.0) -> dict:
    """How far a bf16 kernel's output ``got`` lies from its plain version
    ``want``: ``max_ulps`` (the largest distance in bf16 spacings at the
    larger magnitude of each pair: 0 where the bits agree, 1 for
    neighbours), ``share_differ`` (the share of elements whose bits
    differ), ``share_over_1ulp``, ``max_abs_err`` and
    ``within``: whether every element is within one bf16 spacing plus ``rel
    * scale``, where ``scale`` (float32, got's shape) is the sum of the
    magnitudes of the terms that form the element.  Where a sum cancels, the
    float32 rounding of its terms is many spacings of the small result."""
    g, w = got.float(), want.float()
    spacing = _bf16_spacing(g, w)
    err = (g - w).abs()
    u = err / spacing
    allowed = spacing if scale is None else spacing + rel * scale.float()
    return {"max_ulps": u.max().item(), "share_differ": (u > 0).float().mean().item(),
            "share_over_1ulp": (u > 1).float().mean().item(),
            "max_abs_err": err.max().item(), "within": bool((err <= allowed).all().item())}


def widened(t: torch.Tensor) -> torch.Tensor:
    """A plain version's working copy of ``t``: bfloat16 upcast to float32
    (where a bf16 kernel sums in float32), any other dtype as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def on16(*ts: Optional[torch.Tensor]) -> bool:
    """Every tensor given starts on 16 bytes (TMA's and the bulk copies' base
    alignment)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a copy of it that starts on 16 bytes (the kernels read the
    maps in 16-byte units where the widths allow; a view into a larger tensor
    may start anywhere)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()
