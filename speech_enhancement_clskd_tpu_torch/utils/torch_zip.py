"""Reading a PyTorch checkpoint (``torch.save``) into plain Python + numpy.

Counterpart of ``speech_enhancement_clskd_tpu/utils/torch_zip.py``, which
reads the zip format without torch.  The port has torch, so it reads with
``torch.load(..., weights_only=True)`` (tensors, containers and scalars;
no code from the file runs), allowing the one metadata class an asteroid
publishable bundle carries (``torch.torch_version.TorchVersion`` in its
``infos``), and hands every tensor on as a numpy array: bfloat16 widened
to float32, as the JAX reader does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.serialization import safe_globals
from torch.torch_version import TorchVersion


def _to_numpy(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    if isinstance(obj, dict):
        out = type(obj)()
        for key, val in obj.items():
            out[key] = _to_numpy(val)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Read a torch checkpoint into plain Python + numpy arrays."""
    with safe_globals([TorchVersion]):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    return _to_numpy(obj)
