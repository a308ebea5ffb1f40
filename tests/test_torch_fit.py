"""The port's fit loop against the JAX package's, at the tiny geometry of
``tests/test_train.py``, the port on the CPU: ``load_config``,
``eval_step`` and ``validate``, a 2-epoch synthetic ``fit`` (with
``scan_steps`` 1 and 2), the top-k ``CheckpointManager``, resume, bundles
both ways and the ``distill`` CLI.

Both trainers start from the port's seeded weights: the JAX ``TrainState``
is built from them (``utils.bridge.train_state_arrays``) with a fresh Adam,
so no JAX initialization runs.  The JAX side is compiled once per test
function that needs it (the suite's workers each run whole test functions).
"""

import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu import config as jax_config
from speech_enhancement_clskd_tpu.train.trainer import Trainer as JaxTrainer
from speech_enhancement_clskd_tpu.train.trainer import TrainState
from speech_enhancement_clskd_tpu.utils import serialization as jax_ser
from speech_enhancement_clskd_tpu.utils.observability import MetricWriter as JaxMetricWriter
from speech_enhancement_clskd_tpu_torch import cli
from speech_enhancement_clskd_tpu_torch.config import (
    DataConfig,
    DCCRNConfig,
    OptimConfig,
    TrainConfig,
    load_config,
)
from speech_enhancement_clskd_tpu_torch.data.loader import make_loader
from speech_enhancement_clskd_tpu_torch.models.dccrn import DCCRN
from speech_enhancement_clskd_tpu_torch.train.trainer import Trainer
from speech_enhancement_clskd_tpu_torch.utils import serialization as ser
from speech_enhancement_clskd_tpu_torch.utils.bridge import (
    load_train_state,
    torch_state_from_flax,
    train_state_arrays,
)
from speech_enhancement_clskd_tpu_torch.utils.observability import MetricWriter
from torch_oracle import one_cpu_thread

TINY_T = dict(name="tiny-teacher", kernel_num=(8, 16, 32), rnn_units=32)
TINY_S = dict(name="tiny-student", kernel_num=(4, 8, 8), rnn_units=16)
# 12 clips in batches of 4: 3 steps an epoch, so a window of 2 leaves a tail
DATA = dict(synthetic=True, synthetic_size=12, segment=0.5, batch_size=4)
# float32 both sides, sums in another order.  At the same weights (measured
# worst 2e-6):
EVAL_RTOL = 1e-4
# Along a fit the two runs part as tests/test_torch_trainer.py describes:
# Adam turns the rounding of tiny gradients into moves of ~lr.  Measured
# worst over the 6 steps, against JAX: the losses 4.3e-5, STOI 7.4e-5
# (absolute), the gradient norms 2.2e-4 (a norm of gradients taken at two
# slightly different points; one tensor's parts by up to 5e-3 after 10
# steps), and SI-SDR 1.3e-2.  SI-SDR moves most: the student's conv biases
# in front of a batch-statistics BN have a zero gradient in exact
# arithmetic, so Adam walks them on rounding noise on each side, and
# validation, with BN on running statistics, passes that shift on to the
# estimate.  The last epoch's metrics of the JAX run's final weights are
# then held to EVAL_RTOL.
LOSS_RTOL = 1e-4
STOI_ATOL = 1e-4
GRAD_NORM_DRIFT_RTOL = 1e-3
SI_SDR_DRIFT_RTOL = 3e-2
# what a fit's records hold that is not a number of the model
_NOT_COMPARED = ("step", "scope", "time", "epoch_time_s", "audio_s_per_s")


def _cfg(**kw):
    return TrainConfig(teacher=DCCRNConfig(**TINY_T), student=DCCRNConfig(**TINY_S),
                       data=DataConfig(**DATA), log_every=1, **kw)


def _jax_cfg(**kw):
    return jax_config.TrainConfig(
        teacher=jax_config.DCCRNConfig(**TINY_T), student=jax_config.DCCRNConfig(**TINY_S),
        data=jax_config.DataConfig(**DATA), mesh=jax_config.MeshConfig(data=1, model=1),
        log_every=1, **kw)


def _jax_state(jt, trainer):
    """A JAX ``TrainState`` holding ``trainer``'s weights, at step 0, with
    a fresh Adam (as the port's)."""
    a = {k: jax.tree.map(jnp.asarray, v) for k, v in train_state_arrays(trainer).items()}
    trainable = jt._trainable_of(a["student_params"], a["abf_enc_params"], a["abf_dec_params"])
    return TrainState(step=jnp.zeros((), jnp.int32), opt_state=jt.tx.init(trainable),
                      rng=jax.random.PRNGKey(0), **a)


def _quiet(*_):
    pass


# ------------------------------------------------------------------ config

OVERRIDES = {
    "floats": ["optim.lr=1e-3", "distill.mrstft_factor_mag=0.25", "distill.mrstft_factor_sc=.5"],
    "strings": ["distill.strategy=spkd", "data.task='sep_clean'", "monitor=si_sdr"],
    "tuples": ["distill.mrstft_fft_sizes=[512, 1024]", "student.kernel_num=[4,8,8]",
               "teacher.stft.window=hann"],
    "bools": ["data.synthetic=true", "distill.abf_conv_pallas=yes", "distill.abf_remat=False"],
    "none": ["optim.grad_clip=null", "data.segment=~"],
    "none_as_text": ["optim.grad_clip=None"],
    "ints": ["max_epochs=5", "seed=0x10", "data.shuffle_buffer=1_024", "keep_top_k=010"],
    "mixed": ["optim.lr=6.0e-4", "data.batch_size=16", "optim.grad_clip=1", "scan_steps=2"],
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_load_config_overrides_match_jax(case):
    got = dataclasses.asdict(load_config(None, OVERRIDES[case]))
    want = dataclasses.asdict(jax_config.load_config(None, OVERRIDES[case]))
    assert repr(got) == repr(want)  # the same values of the same types


def test_load_config_yaml_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / "run.yml"
    path.write_text("optim:\n  lr: 1.0e-3\ndata:\n  batch_size: 8\n  synthetic: true\n"
                    "student:\n  kernel_num: [4, 8, 8]\nmax_epochs: 3\n")
    over = ["data.batch_size=4", "distill.strategy=mse"]
    got = dataclasses.asdict(load_config(str(path), over))
    want = dataclasses.asdict(jax_config.load_config(str(path), over))
    assert repr(got) == repr(want)
    # overrides need no yaml; a YAML file does
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert load_config(None, over).data.batch_size == 4
    with pytest.raises(ImportError):
        load_config(str(path), over)
    with pytest.raises(KeyError):
        load_config(None, ["optim.nope=1"])


# ------------------------------------------------------- eval and validate

class _Clips:
    """The first ``n`` items of ``ds``."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


def test_eval_step_and_validate_match_jax():
    trainer = Trainer(_cfg(), device="cpu").init_state(0)
    jt = JaxTrainer(_jax_cfg())
    state = _jax_state(jt, trainer)
    _, val_ds = trainer.make_datasets()
    assert len(val_ds) == 8
    mix, src = next(iter(make_loader(val_ds, 4, shuffle=False)))
    # one source, and two sources scored by a one-output model against s0
    for sources in (src, np.concatenate([src, src[::-1]], axis=1)):
        want, want_est = jt.eval_step(state, jnp.asarray(mix), jnp.asarray(sources))
        got, got_est = trainer.eval_step(mix, sources)
        assert set(got) == set(want) == {"si_sdr", "input_si_sdr", "stoi", "input_stoi",
                                         "si_sdr_imp", "stoi_imp"}
        for k, v in got.items():
            assert v.dim() == 0
            np.testing.assert_allclose(float(v), float(want[k]), rtol=EVAL_RTOL, err_msg=k)
        np.testing.assert_allclose(got_est.numpy(), np.asarray(want_est), rtol=0, atol=1e-5)
    # 6 clips in batches of 4: both drop the last partial batch
    six = _Clips(val_ds, 6)
    want = jt.validate(state, six)
    got = trainer.validate(six)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=EVAL_RTOL, err_msg=k)
    first = trainer.validate(_Clips(val_ds, 4))
    assert first == got  # the tail of 2 was not scored


class _SwappedSources(torch.nn.Module):
    """A stand-in student that emits the two sources in the wrong order."""

    def __init__(self, est):
        super().__init__()
        self.est = est

    def forward(self, mix, training=False):
        return type("Out", (), {"wav": self.est})()


def test_eval_step_pit_reorders_two_sources():
    """As the JAX ``test_eval_step_pit_reorders_two_sources``: only a PIT
    reorder scores swapped estimates well."""
    trainer = Trainer(_cfg(), device="cpu").init_state(0)
    rng = np.random.default_rng(3)
    B, T = 4, 4000
    t = np.arange(T) / 16000.0
    s0 = 0.5 * np.sin(2 * np.pi * 350 * t)[None].repeat(B, 0)
    s1 = 0.5 * np.sign(np.sin(2 * np.pi * 923 * t))[None].repeat(B, 0)
    sources = np.stack([s0, s1], axis=1).astype(np.float32)
    est = (np.stack([s1, s0], axis=1) + 1e-4 * rng.standard_normal((B, 2, T))).astype(np.float32)
    trainer.student = _SwappedSources(torch.from_numpy(est))
    m, _ = trainer.eval_step((s0 + s1).astype(np.float32), sources)
    assert float(m["si_sdr"]) > 30.0
    assert math.isfinite(float(m["stoi"]))


# ------------------------------------------------------------------- fit

def _records(path):
    return MetricWriter.read(str(path))


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_fit_matches_jax(tmp_path, scan_steps):
    """Two epochs of 3 batches.  With ``scan_steps`` 2 the JAX fit runs
    windows of 2 (steps 2 | 4, 6: the epoch's tail carries over), logging
    each window's last step; the port runs the same windows as steps."""
    trainer = Trainer(_cfg(scan_steps=scan_steps), device="cpu").init_state(0)
    jt = JaxTrainer(_jax_cfg(scan_steps=scan_steps))
    state = _jax_state(jt, trainer)
    jw, pw = JaxMetricWriter(str(tmp_path / "jax.jsonl")), MetricWriter(str(tmp_path / "port.jsonl"))
    j_lines, p_lines = [], []
    state, j_hist = jt.fit(state=state, epochs=2, log_fn=j_lines.append, metric_writer=jw)
    p_hist = trainer.fit(epochs=2, log_fn=p_lines.append, metric_writer=pw)
    jw.close()
    pw.close()
    assert trainer.step == int(state.step) == 6 and trainer.epoch == 2
    j_rec, p_rec = _records(tmp_path / "jax.jsonl"), _records(tmp_path / "port.jsonl")
    train_steps = [1, 2, 3, 4, 5, 6] if scan_steps == 1 else [2, 4, 6]
    val_steps = [3, 6] if scan_steps == 1 else [2, 6]
    assert [(r["scope"], r["step"]) for r in p_rec] == [(r["scope"], r["step"]) for r in j_rec]
    assert [r["step"] for r in p_rec if r["scope"] == "train"] == train_steps
    assert [r["step"] for r in p_rec if r["scope"] == "val"] == val_steps
    assert [ln.split(":")[0] for ln in p_lines] == [ln.split(":")[0] for ln in j_lines]
    for got, want in zip(p_rec, j_rec):
        assert set(got) == set(want)
        for k, v in got.items():
            if k in _NOT_COMPARED:
                continue
            if "stoi" in k:
                assert abs(v - want[k]) <= STOI_ATOL, (got["step"], k, v, want[k])
                continue
            rtol = {"si_sdr": SI_SDR_DRIFT_RTOL, "si_sdr_imp": SI_SDR_DRIFT_RTOL}.get(k, LOSS_RTOL)
            if k == "grad_norm" or k.startswith("gn_"):
                rtol = GRAD_NORM_DRIFT_RTOL
            np.testing.assert_allclose(v, want[k], rtol=rtol, err_msg=f"step {got['step']} {k}")
    # the JAX run's final weights, validated by the port: the last epoch's
    # metrics to the tolerances of test_eval_step_and_validate_match_jax
    synced = Trainer(_cfg(), device="cpu").init_state(0)
    load_train_state(synced, jax.tree.map(np.array, state))
    got = synced.validate(trainer.make_datasets()[1])
    for k, v in got.items():
        if "stoi" in k:
            assert abs(v - j_rec[-1][k]) <= STOI_ATOL, k
        else:
            np.testing.assert_allclose(v, j_rec[-1][k], rtol=EVAL_RTOL, err_msg=k)
    assert set(p_hist) == set(j_hist)
    assert p_hist["epoch_time_s"] > 0 and p_hist["audio_s_per_s"] > 0


# a tuned run's optimizer: AdamW, clipping below the step's norm (~1), and
# the cosine schedule after a warmup of one step (lr 0 at the first)
TUNED_OPTIM = OptimConfig(optimizer="adamw", weight_decay=1e-2, grad_clip=0.5,
                          lr_schedule="cosine", warmup_steps=1)


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """2 epochs, a checkpoint, a restore into a new trainer and a third
    epoch give the bits of 3 uninterrupted epochs: the resumed fit starts at
    the checkpoint's epoch counter and shuffles with that epoch."""
    _check_resume(tmp_path, _cfg())


def test_resume_continues_a_tuned_run(tmp_path):
    """The same under AdamW, clipping and the cosine schedule: the restored
    step count continues the schedule, as the learning rate is taken from
    it each step."""
    cfg = _cfg(optim=TUNED_OPTIM)  # on clips of 0.25 s
    resumed = _check_resume(tmp_path, dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, segment=0.25)))
    assert isinstance(resumed.optimizer, torch.optim.AdamW)
    assert resumed.optimizer.param_groups[0]["lr"] == resumed.lr_at(2) > resumed.lr_at(0) == 0


def _check_resume(tmp_path, cfg):
    """The resume checks on ``cfg`` cut to an epoch of one step (4 clips in
    batches of 4); the resumed trainer."""
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, synthetic_size=4))
    straight = Trainer(cfg, device="cpu").init_state(0)
    want = straight.fit(epochs=3, log_fn=_quiet)
    first = Trainer(cfg, device="cpu").init_state(0)
    first.fit(epochs=2, log_fn=_quiet,
              checkpoint_manager=ser.CheckpointManager(str(tmp_path / "ck"), keep_top_k=3))
    resumed = Trainer(cfg, device="cpu").init_state(1)  # other weights, all overwritten
    ser.CheckpointManager(str(tmp_path / "ck"), keep_top_k=3).restore(resumed, step=2)
    assert (resumed.step, resumed.epoch) == (2, 2)
    assert resumed.fit(epochs=2, log_fn=_quiet) == {}  # nothing left to do
    got = resumed.fit(epochs=3, log_fn=_quiet)
    assert (resumed.step, resumed.epoch) == (straight.step, straight.epoch) == (3, 3)
    for k in want:
        if k not in _NOT_COMPARED:
            assert got[k] == want[k], k
    a, b = ser.trainer_state(resumed), ser.trainer_state(straight)
    for part, sd in a["modules"].items():
        for name, t in sd.items():
            assert torch.equal(t, b["modules"][part][name]), (part, name)
    for i, st in a["optimizer"]["state"].items():
        for key, t in st.items():
            assert torch.equal(t, b["optimizer"]["state"][i][key]), (i, key)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    return resumed


# ------------------------------------------------------------- checkpoints

SCRIPTS = {
    "max_ties": ("max", 2, [0.5, 0.8, 0.3, 0.8, 0.9, 0.5, 0.9]),
    "min_ties": ("min", 2, [3.0, 2.0, 2.0, 5.0, 1.0, 1.0, 2.5]),
    "top1": ("max", 1, [0.1, 0.1, 0.2, 0.05, 0.2]),
    "top3_min": ("min", 3, [1.0, 1.0, 1.0, 0.5, 2.0, 0.5, 0.25]),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_checkpoint_manager_keeps_what_jax_keeps(tmp_path, script):
    mode, k, scores = SCRIPTS[script]
    trainer = Trainer(_cfg(), device="cpu").init_state(0)
    port = ser.CheckpointManager(str(tmp_path / "port"), monitor="stoi", mode=mode, keep_top_k=k)
    ref = jax_ser.CheckpointManager(str(tmp_path / "jax"), monitor="stoi", mode=mode,
                                    keep_top_k=k)
    for step, score in enumerate(scores, start=1):
        trainer.step = step
        kept = port.save(trainer, {"stoi": score, "si_sdr": -score})
        want = ref.save({"step": np.int32(step), "w": np.zeros(2, np.float32)}, {"stoi": score})
        assert kept == want, (step, score)
        assert port.best_step() == ref.best_step()
        assert port.best_score() == ref.best_score()
    for name in ("port", "jax"):
        assert json.loads((tmp_path / name / "index.json").read_text())["monitor"] == "stoi"
    index = json.loads((tmp_path / "port" / "index.json").read_text())
    assert index == json.loads((tmp_path / "jax" / "index.json").read_text())
    dirs = sorted(d for d in os.listdir(tmp_path / "port") if d.startswith("step_"))
    assert dirs == sorted(f"step_{int(s):08d}" for s in index["scores"])
    assert dirs == sorted(d for d in os.listdir(tmp_path / "jax") if d.startswith("step_"))
    again = ser.CheckpointManager(str(tmp_path / "port"), monitor="stoi", mode=mode, keep_top_k=k)
    assert again.best_step() == port.best_step()


def test_checkpoint_restores_the_saved_bits(tmp_path):
    trainer = Trainer(_cfg(), device="cpu").init_state(0)
    mix, src = next(iter(make_loader(trainer.make_datasets()[0], 4, shuffle=False)))
    trainer.train_step(mix, src[:, 0])  # Adam state to carry
    mgr = ser.CheckpointManager(str(tmp_path / "ck"), keep_top_k=1)
    assert mgr.save(trainer, {"stoi": 0.5})
    saved = ser.trainer_state(trainer)
    saved = {"modules": {p: {n: t.clone() for n, t in sd.items()}
                         for p, sd in saved["modules"].items()},
             "optimizer": {i: {k: t.clone() for k, t in st.items()}
                           for i, st in saved["optimizer"]["state"].items()}}
    other = Trainer(_cfg(), device="cpu").init_state(3)
    mgr.restore(other)
    got = ser.trainer_state(other)
    assert (other.step, other.epoch) == (1, 0)
    for part, sd in saved["modules"].items():
        for name, t in sd.items():
            assert torch.equal(got["modules"][part][name], t), (part, name)
    for i, st in saved["optimizer"].items():
        for k, t in st.items():
            assert torch.equal(got["optimizer"]["state"][i][k], t), (i, k)
    with pytest.raises(FileNotFoundError):
        ser.CheckpointManager(str(tmp_path / "empty")).restore(other)


# ---------------------------------------------------------------- bundles

def _same_tree(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, dict):
            _same_tree(v, b[k])
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]), err_msg=k)


def test_port_bundle_reads_in_jax_and_in_the_port(tmp_path):
    trainer = Trainer(_cfg(), device="cpu").init_state(0)
    cfg = trainer.cfg.student
    v = ser.student_from_state(trainer, cfg)
    path = str(tmp_path / "student")
    ser.save_bundle(path, v["params"], v["batch_stats"], cfg, infos={"history": {"stoi": 0.5}})
    jcfg, jvars, jmeta = jax_ser.load_bundle(path)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(jax_config.DCCRNConfig(**TINY_S))
    _same_tree(jvars, v)
    assert jmeta["model_name"] == "DCCRN" and jmeta["infos"]["history"] == {"stoi": 0.5}
    assert jmeta["infos"]["software_versions"] == {
        "torch_version": torch.__version__, "framework": "speech_enhancement_clskd_tpu_torch"}
    # the same metadata as the JAX writer's for the same model
    jax_ser.save_bundle(str(tmp_path / "ref"), jvars["params"], jvars["batch_stats"], jcfg)
    _, _, ref_meta = jax_ser.load_bundle(str(tmp_path / "ref"))
    assert jmeta["model_args"] == ref_meta["model_args"]
    assert jmeta["config"] == ref_meta["config"]
    # the port's reader gives a student that serves as the trained one
    pcfg, pvars, _ = ser.load_bundle(path + ".npz")
    assert pcfg == cfg
    student = DCCRN(pcfg)
    student.load_state_dict(torch_state_from_flax(pvars), strict=True)
    wav = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8000)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(student.eval()(wav).wav, trainer.student(wav, training=False).wav)


def test_jax_bundle_reads_in_the_port(tmp_path):
    trainer = Trainer(_cfg(), device="cpu").init_state(2)
    v = ser.student_from_state(trainer, trainer.cfg.student)
    path = str(tmp_path / "jax_student")
    jcfg = jax_config.DCCRNConfig(**TINY_S)
    jax_ser.save_bundle(path, v["params"], v["batch_stats"], jcfg, infos={"strategy": "clskd"})
    cfg, variables, meta = ser.load_bundle(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _same_tree(variables, v)
    assert meta["infos"]["strategy"] == "clskd"


# -------------------------------------------------------------------- CLI

# an epoch of one step: 4 clips in batches of 4
TINY_ARGS = ["data.synthetic=true", "data.synthetic_size=4", "data.segment=0.5",
             "data.batch_size=4", "teacher.kernel_num=[8,16,32]", "teacher.rnn_units=32",
             "student.kernel_num=[4,8,8]", "student.rnn_units=16", "keep_top_k=1"]


def test_distill_cli_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "run")
    argv = ["distill", "--strategy", "clskd", "--device", "cpu", "--out", out] + TINY_ARGS
    assert cli.main(argv + ["max_epochs=2"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["bundle"] == os.path.join(out, "the_best_model.npz")
    assert set(last["final_metrics"]) >= {"stoi", "si_sdr", "epoch_time_s", "audio_s_per_s"}
    mgr = ser.CheckpointManager(out, keep_top_k=1)
    index = json.loads(open(os.path.join(out, "index.json")).read())
    records = MetricWriter.read(os.path.join(out, "metrics.jsonl"))
    val = {r["step"]: r["stoi"] for r in records if r["scope"] == "val"}
    assert list(val) == [1, 2]
    best = max(val, key=val.get)  # the first of equal scores, as top-k keeps it
    assert [int(s) for s in index["scores"]] == [best] == [mgr.best_step()]
    # the bundle is the best checkpoint's student, read by both packages
    cfg, variables, meta = ser.load_bundle(last["bundle"])
    jcfg, jvars, _ = jax_ser.load_bundle(last["bundle"])
    _same_tree(jvars, variables)
    assert meta["infos"]["strategy"] == "clskd"
    trainer = Trainer(load_config(None, TINY_ARGS), device="cpu").init_state(9)
    mgr.restore(trainer)
    _same_tree(ser.student_from_state(trainer, cfg), variables)
    # --resume: from the best checkpoint's epoch (its step, one step an
    # epoch) up to max_epochs=3
    assert cli.main(argv + ["max_epochs=3", "--resume"]) == 0
    printed = capsys.readouterr().out
    assert f"resumed from step {best}" in printed
    steps = [r["step"] for r in MetricWriter.read(os.path.join(out, "metrics.jsonl"))
             if r["scope"] == "val"]
    assert steps[2:] == list(range(best + 1, 4))


# every float32 option of a tuned reviewkd run, on the command line
TUNED_ARGS = ["optim.optimizer=adamw", "optim.weight_decay=1e-2", "optim.grad_clip=0.5",
              "optim.lr_schedule=cosine", "optim.warmup_steps=1", "distill.abf_remat=true",
              "distill.spkd_bn2_fold=true", "distill.abf_conv_ninedot=true",
              "distill.abf_reinit_each_step=true"]


def test_distill_cli_reviewkd_with_the_options(tmp_path, capsys):
    """``distill --strategy reviewkd`` with the options' overrides runs end to
    end on the CPU: two epochs of one step, the best checkpoint's bundle,
    and a trainer built from the same overrides has them all."""
    out = str(tmp_path / "run")
    argv = (["distill", "--strategy", "reviewkd", "--device", "cpu", "--out", out]
            + TINY_ARGS + TUNED_ARGS + ["max_epochs=2", "log_every=1", "data.segment=0.25"])
    assert cli.main(argv) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["bundle"] == os.path.join(out, "the_best_model.npz")
    assert all(math.isfinite(v) for v in last["final_metrics"].values())
    _, _, meta = ser.load_bundle(last["bundle"])
    assert meta["infos"]["strategy"] == "reviewkd"
    records = MetricWriter.read(os.path.join(out, "metrics.jsonl"))
    train = [r for r in records if r["scope"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert "gn_abf" not in train[0] and math.isfinite(train[-1]["train_loss"])
    cfg = load_config(None, TINY_ARGS + TUNED_ARGS + ["distill.strategy=reviewkd", "max_epochs=2"])
    trainer = Trainer(cfg, device="cpu").init_state(0)
    assert trainer.abf_enc.remat and trainer.abf_enc.abf0.conv2.use_ninedot
    assert not trainer.abf_enc.abf0.bn2_affine_out  # the fold is clskd's alone, as in JAX
    assert isinstance(trainer.optimizer, torch.optim.AdamW) and set(trainer.trainable()) == {
        "student"}
    assert trainer.lr_at(0) == 0.0 and trainer.lr_at(1) == pytest.approx(cfg.optim.lr, rel=1e-12)


@pytest.mark.parametrize("argv", [["pretrain"], ["evaluate", "--bundle", "b.npz"],
                                  ["import-torch", "--pth", "a.pth", "--out", "b"], ["bench"]],
                         ids=lambda a: a[0])
def test_cli_unported_subcommands_name_their_item(argv):
    """``bench`` raises naming its item; ``evaluate`` and ``import-torch``,
    ported since, run and stop at the missing file, and ``pretrain``,
    ported since, runs until it asks for the card (``--device cuda``, the
    default) or, with one, for the missing LibriMix manifest."""
    if argv[0] in ("evaluate", "import-torch"):
        assert argv[0] not in cli._UNPORTED
        with pytest.raises(FileNotFoundError):
            cli.main(argv)
        return
    if argv[0] == "pretrain":
        assert argv[0] not in cli._UNPORTED
        with pytest.raises((RuntimeError, FileNotFoundError),
                           match="CUDA is not available|No such file|not found"):
            cli.main(argv)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        cli.main(argv)


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["distill", "--out", str(tmp_path / "x")] + TINY_ARGS)


def test_chip_smoke_fit_phase_rehearsed_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 14 checks, at tiny widths on the CPU (epochs of
    one step): the top-1 checkpoint, the bit-exact restore and the bundle
    serving the restored student's bits."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = smoke.fit_config(str(tmp_path), teacher=DCCRNConfig(**TINY_T),
                           student=DCCRNConfig(**TINY_S))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=4, segment=0.5, synthetic_size=4))
    rec = smoke.fit_checks(cfg, "cpu", {})
    assert rec["failures"] == []
    assert rec["steps"] == rec["epochs"] == smoke.FIT_EPOCHS
    assert rec["kept"] == [rec["best_step"]] and rec["restore_bit_equal"]
    assert rec["bundle_serves_restored_bits"]
    assert rec["stoi_abs_err"] == 0 and rec["si_sdr_abs_err_db"] == 0  # CPU against CPU


# the training phases' checks rehearsed on 2 clips of 0.25 s, the least
# batch SPKD takes
REHEARSAL_CLIPS = (2, 0.25)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_reviewkd_phase_rehearsed_on_the_cpu():
    """chip_smoke.py's phase 15 check at tiny widths on the CPU: the CPU
    against itself from the same state, with zero error, and the gradients'
    rounding floor measured."""
    smoke = _chip_smoke()
    cfg = smoke.train_config(*REHEARSAL_CLIPS, smoke.REVIEWKD, teacher=DCCRNConfig(**TINY_T),
                             student=DCCRNConfig(**TINY_S))
    rec = smoke.card_vs_cpu_checks(cfg, "cpu", rounding_floor=True)
    assert rec["failures"] == []
    for r in (rec["gaussian"], rec["speech"]):
        assert [s["loss_rel_err"] for s in r["steps"]] == [0.0]
    assert rec["gaussian"]["steps"][0]["grad_max_rel_l2"] == 0.0
    assert rec["gaussian"]["steps"][0]["rounding_floor"] > 0.0


def test_chip_smoke_options_phase_rehearsed_on_the_cpu():
    """chip_smoke.py's phase 16 check at tiny widths on the CPU: 3 steps of
    the options (learning rates 0, lr / 2, lr; every step clipped) and one
    step of the nine-dot conv with the ABF re-init, CPU against CPU with
    zero error."""
    smoke = _chip_smoke()
    models = dict(teacher=DCCRNConfig(**TINY_T), student=DCCRNConfig(**TINY_S))
    cfg = smoke.train_config(*REHEARSAL_CLIPS, smoke.OPTION_DISTILL, smoke.OPTION_OPTIM,
                             **models)
    xla_cfg = smoke.train_config(*REHEARSAL_CLIPS, smoke.XLA_ROUTE_DISTILL, **models)
    rec = smoke.option_checks(cfg, xla_cfg, "cpu")
    assert rec["failures"] == []
    steps = rec["options"]["steps"] + rec["xla_route"]["steps"]
    assert len(steps) == smoke.OPTION_CHECK_STEPS + 1
    assert all(s["loss_rel_err"] == 0.0 and s["grad_max_rel_l2"] == 0.0 for s in steps)
    lr = cfg.optim.lr
    assert [s["lr"] for s in rec["options"]["steps"]] == [0.0, lr / 2, lr]
    assert all(s["grad_norm"] > s["clipped_norm"] for s in rec["options"]["steps"])
