"""Carrying weights between a flax variable tree and a torch state_dict.

The flax tree is ``{"params": {...}, "batch_stats": {...}}`` nested by module
name (``enc0_conv``, ``clstm1`` -> ``real_lstm``, ...).  The state_dict key is
the same path joined with dots (``enc0_conv.wr``, ``clstm1.real_lstm.w_hh``);
the BatchNorm running statistics become buffers of their module
(``enc0_bn.mean``, ``enc0_bn.var``).

Layouts.  Complex conv weights ``wr``/``wi`` are HWIO ``[kh, kw, I, O]`` in
flax.  The port keeps them in the layout ``torch.nn.functional`` wants:
``[O, I, kh, kw]`` for ``conv2d`` (encoder ``enc*_conv``) and
``[I, O, kh, kw]`` for ``conv_transpose2d`` (decoder ``dec*_conv`` and the
DCCRNet mask output ``out_conv``).  Every
other leaf keeps its flax layout: biases, BN ``scale``/``bias``/``mean``/
``var``, PReLU ``alpha`` (``alpha_r``/``alpha_i``), the complex dense ``rnn_linear``
``wr``/``wi [F, O]``, LSTM ``w_ih [F, 4H]``, ``w_hh [H, 4H]``, ``b_ih``,
``b_hh`` and the projection ``proj_wr [H, P]``/``proj_br``/``proj_wi``/
``proj_bi``.

The ABF chains (``distill.abf.ReviewKD``) follow the same rule: under
``abf{i}``, ``conv1.kernel [1, 1, I, O]``, ``att_conv.kernel [1, 1, 2C, 2]``
and ``att_conv.bias``, and ``bn1``/``bn2`` as above, keep their flax layouts;
the 3x3 ``conv2.kernel`` goes from HWIO ``[3, 3, I, O]`` to ``[O, I, 3, 3]``.
Both directions only permute axes, so a round trip is exact.

``load_train_state`` carries a JAX ``TrainState`` (student, teacher and,
for a strategy with fusion, both ABF chains, parameters and statistics) into
a port ``train.trainer.Trainer``; ``train_state_arrays`` reads them back in
flax layouts.  Both walk the parts the trainer has: a trainer without ABF
chains (``spkd``, ``mse``, ``stft``) takes a state whose ``abf_*`` fields
are ``None``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_STATS = ("mean", "var")
_CONV_WEIGHTS = ("wr", "wi")
# the transposed convs: the DCCRN decoders, and the DCCRNet decoders and
# mask output
_TRANSPOSED = re.compile(r"dec\d+_conv|out_conv")
# HWIO -> torch layout, per conv kind; the inverse permutation goes back
_TO_TORCH = {False: (3, 2, 0, 1), True: (2, 3, 0, 1)}
# the parts of a TrainState, each a module of the port's Trainer (the ABF
# chains only for a strategy with fusion)
TRAIN_STATE_PARTS = ("student", "teacher", "abf_enc", "abf_dec")


def trainer_parts(trainer) -> Tuple[str, ...]:
    """The parts of ``TRAIN_STATE_PARTS`` that ``trainer`` has."""
    return tuple(p for p in TRAIN_STATE_PARTS if getattr(trainer, p) is not None)


def _perm(path: tuple) -> "tuple | None":
    if path[-1] in _CONV_WEIGHTS and len(path) >= 2 and path[-2].endswith("_conv"):
        return _TO_TORCH[bool(_TRANSPOSED.fullmatch(path[-2]))]
    if path[-2:] == ("conv2", "kernel"):  # ABF 3x3 conv, for F.conv2d
        return _TO_TORCH[False]
    return None


def _walk(tree: Mapping[str, Any], prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def torch_state_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree -> state_dict of CPU tensors."""
    state: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(coll, {})):
            arr = np.asarray(leaf)
            perm = _perm(path)
            if perm is not None:
                arr = arr.transpose(perm)
            state[".".join(path)] = torch.from_numpy(np.array(arr, order="C"))
    return state


def flax_from_torch_state(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``torch_state_from_flax``: numpy leaves in flax layouts."""
    variables: Dict[str, Any] = {"params": {}}
    for key, tensor in state.items():
        path = tuple(key.split("."))
        arr = tensor.detach().cpu().numpy()
        perm = _perm(path)
        if perm is not None:
            arr = arr.transpose(np.argsort(perm))
        coll = "batch_stats" if path[-1] in _STATS else "params"
        d = variables.setdefault(coll, {})
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = np.array(arr, order="C")  # a copy, never a view of the tensor
    return variables


def load_train_state(trainer, state) -> None:
    """Load a JAX ``TrainState``'s parameters and BN statistics (its
    ``{part}_params`` and ``{part}_stats`` trees, numpy-convertible leaves)
    into ``trainer``'s modules, strictly, and start its Adam afresh (the
    state's optimizer moments are not carried).  The state holds a part
    (its ``{part}_params`` is not ``None``) exactly where the trainer has its
    module, or this raises.  ``trainer.init_state()`` must have run."""
    if trainer.optimizer is None:
        raise RuntimeError("call trainer.init_state() before loading a state")
    parts = trainer_parts(trainer)
    in_state = tuple(p for p in TRAIN_STATE_PARTS if getattr(state, f"{p}_params") is not None)
    if in_state != parts:
        raise ValueError(f"the state holds {in_state}, the trainer {parts}")
    for part in parts:
        variables = {"params": getattr(state, f"{part}_params"),
                     "batch_stats": getattr(state, f"{part}_stats") or {}}
        getattr(trainer, part).load_state_dict(torch_state_from_flax(variables), strict=True)
    trainer.optimizer.state.clear()
    trainer.step = int(np.asarray(state.step))


def train_state_arrays(trainer) -> Dict[str, Any]:
    """``{part}_params`` and ``{part}_stats`` of ``trainer``'s modules as
    numpy trees in flax layouts: the inverse of ``load_train_state``."""
    out: Dict[str, Any] = {}
    for part in trainer_parts(trainer):
        variables = flax_from_torch_state(getattr(trainer, part).state_dict())
        out[f"{part}_params"] = variables["params"]
        out[f"{part}_stats"] = variables.get("batch_stats", {})
    return out
