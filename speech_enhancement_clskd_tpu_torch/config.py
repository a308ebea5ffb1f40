"""Configuration for the PyTorch port.

The port's own copy of the dataclasses of
``speech_enhancement_clskd_tpu/config.py``: the model (``STFTConfig``,
``DCCRNConfig`` and the four named geometries) and training (``DataConfig``,
``DistillConfig``, ``OptimConfig``, ``TrainConfig``).  ``MeshConfig`` comes
with data parallelism and YAML loading with the CLI; nothing here needs
``yaml``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


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
    # asteroid-compatible serving family (not ported yet)
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
class TrainConfig:
    teacher: DCCRNConfig = field(default_factory=lambda: TEACHER)
    student: DCCRNConfig = field(default_factory=lambda: STUDENT)
    data: DataConfig = field(default_factory=DataConfig)
    distill: DistillConfig = field(default_factory=DistillConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    max_epochs: int = 20
    seed: int = 0
    log_every: int = 50
    scan_steps: int = 1  # steps per host dispatch; >1 is not ported
    eval_every_epochs: int = 1
    ckpt_dir: str = "checkpoints"
    keep_top_k: int = 3  # checkpoint on max STOI
    monitor: str = "stoi"
    loss_mode: str = "SDR+PMSQE"  # for standalone DCCRN training
