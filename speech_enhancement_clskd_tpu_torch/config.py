"""Configuration for the PyTorch port.

The port's own copy of the dataclasses of
``speech_enhancement_clskd_tpu/config.py``: the model (``STFTConfig``,
``DCCRNConfig`` and the four named geometries) and training (``DataConfig``,
``DistillConfig``, ``OptimConfig``, ``MeshConfig``, ``TrainConfig``), and
``load_config``: defaults, then a YAML file, then dotted ``key.path=value``
overrides (``mesh.data=2`` among them).  ``to_yaml`` writes a config back
out.

``yaml`` is imported only when a YAML file is read or written (the card's
machine has none).  Override values are read by ``_parse_value`` without it,
with the scalar rules of PyYAML's ``safe_load`` (YAML 1.1: ``yes``/``on``
are booleans, ``~``/``null`` are ``None``, ``0x1f`` and ``017`` are integers)
and flow collections (``[512, 1024]``, ``{a: 1}``), then the JAX loader's
fallback that reads a string such as ``1e-3`` (not a YAML 1.1 float) as a
number.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class STFTConfig:
    """Analysis/synthesis frontend."""

    sample_rate: int = 16000
    win_len: int = 400
    hop: int = 100
    fft_len: int = 512
    window: str = "hamming"  # scipy get_window name, periodic (fftbins=True)


@dataclass(frozen=True)
class DCCRNConfig:
    """One parameterized family covering teacher and student.

    Teacher geometry: kernel_num (32..256), rnn_units 256.  Student:
    kernel_num (8..64), rnn_units 64.
    """

    name: str = "dccrn"
    # 'dccrn' = the reference's own DCCRN model; 'dccrnet' = the
    # asteroid-compatible serving family (models/dccrnet.py)
    family: str = "dccrn"
    stft: STFTConfig = field(default_factory=STFTConfig)
    kernel_num: Tuple[int, ...] = (32, 64, 128, 256, 256, 256)
    kernel_size: int = 5
    rnn_layers: int = 2
    rnn_units: int = 256
    masking_mode: str = "E"  # 'E' | 'C' | 'R'
    use_clstm: bool = True
    use_cbn: bool = False  # complex batchnorm instead of real BN
    bidirectional: bool = False
    compute_dtype: str = "float32"

    @property
    def hidden_freq(self) -> int:
        """Frequency bins left after the encoder stack."""
        return self.stft.fft_len // (2 ** (len(self.kernel_num) + 1))

    def scaled(self, div: int, name: Optional[str] = None) -> "DCCRNConfig":
        """Student variant with channels and rnn units divided by ``div``."""
        return dataclasses.replace(
            self,
            name=name or f"{self.name}-div{div}",
            kernel_num=tuple(k // div for k in self.kernel_num),
            rnn_units=self.rnn_units // div,
        )


TEACHER = DCCRNConfig(name="dccrn-cl")
STUDENT = DCCRNConfig(
    name="dccrn-cl-test",
    kernel_num=(8, 16, 32, 64, 64, 64),
    rnn_units=64,
)

# asteroid-compatible serving family; sqrt-Hann frontend
DCCRNET_TEACHER = DCCRNConfig(
    name="dccrnet-cl",
    family="dccrnet",
    stft=STFTConfig(window="sqrthann"),
)
DCCRNET_STUDENT = DCCRNConfig(
    name="dccrnet-cl-test",
    family="dccrnet",
    stft=STFTConfig(window="sqrthann"),
    kernel_num=(8, 16, 32, 64, 64, 64),
    rnn_units=64,
)


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "librimix"  # 'librimix' | 'dns'
    task: str = "enh_single"
    sample_rate: int = 16000
    n_src: int = 1
    segment: Optional[float] = 3.0  # seconds; None = full utterances
    train_dir: str = "data/wav16k/min/train-360"
    valid_dir: str = "data/wav16k/min/dev"
    test_dir: str = "data/wav16k/max/test"
    batch_size: int = 32
    shuffle_buffer: int = 2048
    synthetic: bool = False  # use the synthetic generator (no corpus on disk)
    synthetic_size: int = 2048
    synthetic_profile: str = "default"  # 'default' | 'hard'


@dataclass(frozen=True)
class DistillConfig:
    """Which distillation strategy and loss weights.

    strategy: 'clskd' | 'reviewkd' | 'spkd' | 'mse' | 'stft'.  The loss is
    always computed in float32.
    """

    strategy: str = "clskd"
    # MRSTFT base loss: single resolution 512/100/400
    mrstft_fft_sizes: Tuple[int, ...] = (512,)
    mrstft_hop_sizes: Tuple[int, ...] = (100,)
    mrstft_win_lengths: Tuple[int, ...] = (400,)
    mrstft_factor_mag: float = 0.1
    mrstft_factor_sc: float = 0.1
    # ABF fusion: trainable (abf_reinit_each_step reproduces the reference's
    # fresh, untrained fusion blocks of every step)
    abf_trainable: bool = True
    abf_reinit_each_step: bool = False
    abf_mid_channels: int = 64
    distill_weight: float = 1.0
    taps_dtype: str = "float32"  # dtype of the taps entering fusion/SPKD
    abf_remat: bool = False  # recompute ABF blocks in backward
    # the ABF chain's opt-in kernels (K3 conv3x3, K4 attention fuse, K5 the
    # whole block); off by default
    abf_conv_pallas: bool = False
    abf_conv_ninedot: bool = False  # 3x3 conv as 9 shifted matmuls
    abf_attfuse_pallas: bool = False
    abf_block_pallas: bool = False
    # SPKD Gram scope: 1 = one Gram over the whole batch; >1 = per-group
    # Grams averaged (set to the data-parallel size)
    spkd_gram_groups: int = 1
    # fold the ABF bn2 affine into per-channel SPKD Grams (clskd only)
    spkd_bn2_fold: bool = False


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"
    lr: float = 6e-4
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None
    lr_schedule: str = "constant"  # 'constant' | 'cosine'
    warmup_steps: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """The ranks' layout: ``data`` x ``model`` (the JAX ``MeshConfig``).
    ``data=-1`` takes every rank the model axis leaves
    (``parallel.mesh.make_mesh``); the trainers run data parallel over the
    data axis and do not take ``model > 1`` yet."""

    data: int = -1
    model: int = 1


@dataclass(frozen=True)
class TrainConfig:
    teacher: DCCRNConfig = field(default_factory=lambda: TEACHER)
    student: DCCRNConfig = field(default_factory=lambda: STUDENT)
    data: DataConfig = field(default_factory=DataConfig)
    distill: DistillConfig = field(default_factory=DistillConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    max_epochs: int = 20
    seed: int = 0
    log_every: int = 50
    # >1: fit() gathers this many batches and then runs them as that many
    # steps (the JAX fit's scan window; the tail carries into the next epoch)
    scan_steps: int = 1
    eval_every_epochs: int = 1
    ckpt_dir: str = "checkpoints"
    keep_top_k: int = 3  # checkpoint on max STOI
    monitor: str = "stoi"
    loss_mode: str = "SDR+PMSQE"  # for standalone DCCRN training


# ---------------------------------------------------------------------------
# YAML + CLI override machinery
# ---------------------------------------------------------------------------


def _from_dict(cls, d: Dict[str, Any]):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, val in d.items():
        if key not in fields:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        f = fields[key]
        sub = f.type if dataclasses.is_dataclass(f.type) else None
        if sub is None and f.default_factory is not dataclasses.MISSING:  # type: ignore
            probe = f.default_factory()  # type: ignore
            sub = type(probe) if dataclasses.is_dataclass(probe) else None
        if sub is not None and isinstance(val, dict):
            kwargs[key] = _from_dict(sub, val)
        elif isinstance(val, list):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


def _set_dotted(d: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


# PyYAML's implicit scalar resolvers (YAML 1.1), as ``yaml.safe_load`` applies them
_YAML_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                                   "on", "On", "ON")},
              **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                                    "off", "Off", "OFF")}}
_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_INT = re.compile(r"""[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_YAML_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)""", re.X)


def _sexagesimal(sign: int, value: str, num) -> Any:
    total, base = 0, 1
    for digit in reversed(value.split(":")):
        total += num(digit) * base
        base *= 60
    return sign * total


def _yaml_scalar(s: str) -> Any:
    """A plain (unquoted) scalar as PyYAML's SafeLoader resolves it."""
    if s in _YAML_NULL:
        return None
    if s in _YAML_BOOL:
        return _YAML_BOOL[s]
    if _YAML_INT.fullmatch(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return _sexagesimal(sign, v, int)
        return sign * int(v)
    if _YAML_FLOAT.fullmatch(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return _sexagesimal(sign, v, float)
        return sign * float(v)
    return s


class _FlowParser:
    """A one-line YAML value: a plain or quoted scalar, or a flow sequence or
    mapping of them.  Raises ``ValueError`` where ``yaml.safe_load`` would
    raise ``yaml.YAMLError``."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def parse(self) -> Any:
        self._skip()
        if self.i < len(self.s) and self.s[self.i] in "[{\"'":
            v = self._node()
            self._skip()
            if self.i != len(self.s):
                raise ValueError("text after the value")
            return v
        key, colon, rest = self.s.partition(": ")
        if colon:  # a one-entry block mapping, ``key: value``
            return {_yaml_scalar(key.strip()): _FlowParser(rest).parse()}
        return _yaml_scalar(self.s.strip())

    def _node(self) -> Any:
        self._skip()
        c = self.s[self.i] if self.i < len(self.s) else ""
        if c == "[":
            return self._collection("]", mapping=False)
        if c == "{":
            return self._collection("}", mapping=True)
        if c in "\"'":
            return self._quoted(c)
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in ",]}":
            if self.s[self.i] == ":" and self.s[self.i + 1:self.i + 2] in (" ", ""):
                break
            self.i += 1
        return _yaml_scalar(self.s[start:self.i].strip())

    def _quoted(self, q: str) -> str:
        end = self.s.find(q, self.i + 1)
        if end < 0:
            raise ValueError("unterminated quote")
        text = self.s[self.i + 1:end]
        self.i = end + 1
        return text

    def _collection(self, close: str, mapping: bool) -> Any:
        self.i += 1
        out: Any = {} if mapping else []
        while True:
            self._skip()
            if self.i >= len(self.s):
                raise ValueError(f"missing {close!r}")
            if self.s[self.i] == close:
                self.i += 1
                return out
            item = self._node()
            self._skip()
            if mapping:
                if self.s[self.i:self.i + 1] != ":":
                    raise ValueError("a mapping entry needs ':'")
                self.i += 1
                out[item] = self._node()
                self._skip()
            else:
                out.append(item)
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != close:
                raise ValueError(f"expected ',' or {close!r}")


def _parse_value(s: str) -> Any:
    try:
        v = _FlowParser(s).parse()
    except ValueError:
        return s
    # YAML 1.1 parses '1e-3' as a string (needs '1.0e-3'); recover numerics
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            try:
                return float(v)
            except ValueError:
                return v
    return v


def load_config(
    yaml_path: Optional[str] = None,
    overrides: Sequence[str] = (),
    base: Optional[TrainConfig] = None,
) -> TrainConfig:
    """Build a TrainConfig from defaults, then YAML, then ``key=value`` overrides.

    Overrides use dotted paths, e.g. ``optim.lr=1e-3 distill.strategy=spkd``.
    Only a YAML file needs ``yaml``.
    """
    d: Dict[str, Any] = dataclasses.asdict(base or TrainConfig())
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            loaded = yaml.safe_load(f) or {}
        _deep_update(d, loaded)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must look like key.path=value")
        key, val = ov.split("=", 1)
        _set_dotted(d, key, _parse_value(val))
    return _from_dict(TrainConfig, d)


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def to_yaml(cfg) -> str:
    """``cfg`` (any config dataclass) as YAML, fields in declaration order;
    needs ``yaml``, imported here (the card's machine has none)."""
    import yaml

    return yaml.safe_dump(dataclasses.asdict(cfg), sort_keys=False)
