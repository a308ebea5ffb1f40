"""The port's asteroid DCCRNet family against the JAX package on the CPU:
the filterbank, the forward (eval mode and batch statistics; wav, masks and
every tap), the ``.pth`` reader, ``params_from_asteroid_state_dict``, both
``import-torch`` CLIs, ``evaluate_bundle`` on a ``.pth``, streaming, the
bridge's ``out_conv`` round trip, and the new complex layers.

The ``.pth`` bundles are seeded asteroid-schema files written by
``chip_smoke.write_asteroid_pth`` (the reference checkpoint is not in the
repository)."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_clskd_tpu import cli as jax_cli
from speech_enhancement_clskd_tpu.config import DCCRNConfig as JaxDCCRNConfig
from speech_enhancement_clskd_tpu.config import STFTConfig as JaxSTFTConfig
from speech_enhancement_clskd_tpu.data.synthetic import (
    SyntheticEnhancementDataset as JaxSynthetic,
)
from speech_enhancement_clskd_tpu.eval import evaluate_bundle as jax_evaluate_bundle
from speech_enhancement_clskd_tpu.eval.streaming import StreamingEnhancer as JaxStreamingEnhancer
from speech_enhancement_clskd_tpu.models import dccrnet as jax_dccrnet
from speech_enhancement_clskd_tpu.ops import complex_layers as jax_layers
from speech_enhancement_clskd_tpu.utils.torch_zip import (
    load_torch_checkpoint as jax_load_torch_checkpoint,
)
from speech_enhancement_clskd_tpu_torch import cli
from speech_enhancement_clskd_tpu_torch.config import DCCRNET_TEACHER, DCCRNConfig, STFTConfig
from speech_enhancement_clskd_tpu_torch.data.synthetic import SyntheticEnhancementDataset
from speech_enhancement_clskd_tpu_torch.eval import evaluate_bundle
from speech_enhancement_clskd_tpu_torch.eval.streaming import StreamingEnhancer
from speech_enhancement_clskd_tpu_torch.models import dccrnet
from speech_enhancement_clskd_tpu_torch.models.dccrn import make_model
from speech_enhancement_clskd_tpu_torch.ops import complex_layers as layers
from speech_enhancement_clskd_tpu_torch.utils.bridge import (
    flax_from_torch_state,
    torch_state_from_flax,
)
from speech_enhancement_clskd_tpu_torch.utils.serialization import load_bundle
from speech_enhancement_clskd_tpu_torch.utils.torch_zip import load_torch_checkpoint
from torch_oracle import jitted_jax_stoi, once_per_session, one_cpu_thread

ROOT = Path(__file__).resolve().parents[1]
# float32 on both sides, sums in another order: measured worst 2.4e-7 on
# the wav, 1.0e-6 on the masks and 8.9e-6 on a tap of the batch-statistics
# forward (1.6e-6 of its largest value) at DCCRN-CL-test
ATOL = RTOL = 1e-5
TINY = dict(name="tiny", family="dccrnet", kernel_num=(4, 8, 8), rnn_units=16)
STUDENT = "DCCRN-CL-test"


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def smoke():
    return _smoke()


@pytest.fixture(scope="module")
def student_pth(tmp_path_factory, smoke):
    path = tmp_path_factory.mktemp("asteroid") / "student.pth"
    return smoke.write_asteroid_pth(str(path), STUDENT, seed=3)


@pytest.fixture(scope="module")
def tiny_variables(tmp_path_factory):
    return once_per_session(tmp_path_factory, "dccrnet-tiny-variables", _tiny_variables)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        assert np.array_equal(g[k], w[k]), k


def _tiny_variables():
    cfg = JaxDCCRNConfig(stft=JaxSTFTConfig(window="sqrthann"), **TINY)
    v = jax.jit(lambda k: jax_dccrnet.DCCRNet(cfg=cfg).init(k, jnp.zeros((1, 1600)),
                                                            training=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    # non-trivial biases, slopes and running statistics
    v = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                     .astype(np.float32), jax.tree.map(np.asarray, v))
    v["batch_stats"] = jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape)
                                    .astype(np.float32), v["batch_stats"])
    return v


def _jax_forward(cfg_kw, variables, wav, bn_batch_stats):
    cfg = JaxDCCRNConfig(**cfg_kw)
    out = jax.jit(lambda v, w: jax_dccrnet.DCCRNet(cfg=cfg).apply(
        v, w, training=False, bn_batch_stats=bn_batch_stats))(variables, jnp.asarray(wav))
    taps = out.taps
    return {"wav": out.wav, "mask_real": out.mask_real, "mask_imag": out.mask_imag,
            "est_real": out.est_real, "est_imag": out.est_imag,
            "encoder": list(taps.encoder), "decoder": list(taps.decoder),
            "lstm_real": taps.lstm_real, "lstm_imag": taps.lstm_imag}


def test_asteroid_filterbank_exact():
    assert np.array_equal(dccrnet.asteroid_filterbank(), jax_dccrnet.asteroid_filterbank())


def test_dccrn_cl_parameter_count():
    model = make_model(DCCRNET_TEACHER, device="cpu")
    assert isinstance(model, dccrnet.DCCRNet)
    assert sum(p.numel() for p in model.parameters()) == 3_669_336


@pytest.mark.parametrize("geometry", ["tiny", STUDENT])
@pytest.mark.parametrize("bn_batch_stats", [None, True])
def test_forward_matches_jax(tmp_path_factory, student_pth, tiny_variables, geometry,
                             bn_batch_stats):
    """wav, masks, the masked spectrum and every tap; tiny geometry on
    0.5 s, DCCRN-CL-test on 1 s."""
    if geometry == "tiny":
        cfg_kw = dict(stft=STFTConfig(window="sqrthann"), **TINY)
        jax_kw = dict(stft=JaxSTFTConfig(window="sqrthann"), **TINY)
        variables = tiny_variables
        samples = 8000
    else:
        cfg = dccrnet.config_from_model_args({"architecture": geometry})
        cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        jax_kw = dict(cfg_kw, stft=JaxSTFTConfig(**dataclasses.asdict(cfg.stft)))
        variables = dccrnet.read_reference_bundle(student_pth)[1]
        samples = 16000
    wav = (0.3 * np.random.default_rng(2).standard_normal((2, samples))).astype(np.float32)
    want = once_per_session(  # both modes in one oracle, sharing the variables
        tmp_path_factory, f"dccrnet-forward-{geometry}",
        lambda: {bn: jax.tree.map(np.asarray, _jax_forward(jax_kw, variables, wav, bn))
                 for bn in (None, True)})[bn_batch_stats]
    model = make_model(DCCRNConfig(**cfg_kw), device="cpu")
    model.load_state_dict(torch_state_from_flax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(wav), bn_batch_stats=bn_batch_stats)
    for name in ("wav", "mask_real", "mask_imag", "est_real", "est_imag"):
        np.testing.assert_allclose(getattr(got, name).numpy(), want[name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    assert len(got.taps.encoder) == len(got.taps.decoder) == len(cfg_kw["kernel_num"])
    for kind in ("encoder", "decoder"):
        for i, (g, w) in enumerate(zip(getattr(got.taps, kind), want[kind])):
            assert tuple(g.shape) == w.shape, (kind, i)
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=f"{kind}{i}")
    for name in ("lstm_real", "lstm_imag"):
        np.testing.assert_allclose(getattr(got.taps, name).numpy(), want[name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    # T shrinks one frame a layer: 157 frames of 1 s -> 151 at the LSTM
    if geometry == STUDENT:
        assert got.taps.lstm_real.shape == (151, 2, 32)
        assert got.mask_real.shape == (2, 257, 157)


def test_torch_zip_readers_agree(student_pth, tmp_path):
    """The port's ``torch.load`` reader against the JAX pure-Python reader,
    on the seeded bundle and on a file with bf16, int and 0-d tensors."""
    for path in (student_pth, str(tmp_path / "mixed.pth")):
        if path != student_pth:
            g = torch.Generator().manual_seed(0)
            torch.save({"a": [torch.randn(3, 4, generator=g).to(torch.bfloat16),
                              torch.arange(5), torch.tensor(2.5)],
                        "t": torch.randn(4, 6, generator=g).t(),
                        "version": torch.__version__, "n": 3}, path)
        got, want = load_torch_checkpoint(path), jax_load_torch_checkpoint(path)
        assert set(got) == set(want)
        flat_g = dict(_leaves({k: v for k, v in got.items() if isinstance(v, dict)}))
        flat_w = dict(_leaves({k: v for k, v in want.items() if isinstance(v, dict)}))
        assert list(flat_g) == list(flat_w)
        for k in flat_w:
            if flat_w[k].dtype == object:
                assert flat_g[k].item() == flat_w[k].item(), k
            else:
                assert flat_g[k].dtype == flat_w[k].dtype and np.array_equal(
                    flat_g[k], flat_w[k]), k
        if path == student_pth:
            assert got["model_name"] == want["model_name"] == "DCCRNet_mini"
            assert got["model_args"] == want["model_args"]
            assert list(got["state_dict"]) == list(want["state_dict"])
        else:
            for g_, w_ in zip(got["a"], want["a"]):
                assert g_.dtype == w_.dtype and np.array_equal(g_, w_)
            assert np.array_equal(got["t"], want["t"]) and got["t"].flags.c_contiguous
            assert got["version"] == want["version"] and got["n"] == want["n"]


def test_params_from_asteroid_state_dict_matches_jax(student_pth):
    ck = jax_load_torch_checkpoint(student_pth)
    jcfg = jax_dccrnet.config_from_model_args(ck["model_args"])
    want = jax.tree.map(np.asarray,
                        jax_dccrnet.params_from_asteroid_state_dict(ck["state_dict"], jcfg))
    cfg, got, _ = dccrnet.read_reference_bundle(student_pth)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_trees_equal(got, want)
    # every masker tensor but the BN counters is consumed
    n = sum(int(np.asarray(v).size) for k, v in ck["state_dict"].items()
            if k.startswith("masker") and "num_batches_tracked" not in k)
    assert sum(a.size for _, a in _leaves(got)) == n


def test_import_torch_clis_agree(student_pth, tmp_path):
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert cli.main(["import-torch", "--pth", student_pth, "--out", ours]) == 0
    assert jax_cli.main(["import-torch", "--pth", student_pth, "--out", theirs]) == 0
    cfg, variables, meta = load_bundle(ours)
    jcfg, jvariables, jmeta = load_bundle(theirs)
    assert cfg == jcfg and cfg.family == "dccrnet" and cfg.name == "dccrn-cl-test"
    assert meta["model_args"] == jmeta["model_args"] and meta["model_name"] == "DCCRNet"
    assert meta["infos"]["source_model_name"] == "DCCRNet_mini"
    _assert_trees_equal(variables, jvariables)


def test_evaluate_bundle_pth_matches_jax(student_pth, tmp_path_factory):
    """``evaluate_bundle`` on the ``.pth`` with the reference's batch
    statistics and PESQ, against the JAX one: the summary's metrics."""
    kw = dict(sample_rate=16000, compute_pesq=True, bn_batch_stats=True, log_fn=lambda *_: None)
    def compute():
        with jitted_jax_stoi():
            return jax_evaluate_bundle(student_pth, JaxSynthetic(size=2, segment=0.75, seed=7),
                                       **kw)

    want = once_per_session(tmp_path_factory, "dccrnet-evaluate-pth", compute)
    got = evaluate_bundle(student_pth, SyntheticEnhancementDataset(size=2, segment=0.75, seed=7),
                          device="cpu", **kw)
    assert set(got) == set(want) and "pesq" in got
    for k in want:
        tol = 1e-5 if k.startswith("stoi") else 1e-3
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_streaming_matches_jax(tmp_path_factory, tiny_variables):
    """DCCRNet streaming (its lookahead guard included) against the JAX
    ``StreamingEnhancer`` at tiny geometry."""
    variables = tiny_variables
    chunk = dict(chunk_frames=8, context_frames=16)
    wav = (0.3 * np.random.default_rng(4).standard_normal(5000)).astype(np.float32)
    jcfg = JaxDCCRNConfig(stft=JaxSTFTConfig(window="sqrthann"), **TINY)
    want = once_per_session(tmp_path_factory, "dccrnet-streaming",
                            lambda: JaxStreamingEnhancer(jcfg, variables, **chunk).stream(wav))
    eng = StreamingEnhancer(DCCRNConfig(stft=STFTConfig(window="sqrthann"), **TINY),
                            torch_state_from_flax(variables), device="cpu", **chunk)
    assert eng.guard == (400 // 100 - 1 + 2 * 3 + 1) * 100
    got = eng.stream(wav)
    assert got.shape == wav.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_bridge_round_trip_with_out_conv(student_pth):
    """``out_conv`` is a transposed conv: ``[I, O, kh, kw]`` in the port,
    and flax -> torch -> flax is exact."""
    cfg, variables, _ = dccrnet.read_reference_bundle(student_pth)
    state = torch_state_from_flax(variables)
    assert tuple(state["out_conv.wr"].shape) == (8, 1, 5, 2)  # [out, skip] of 4 + 4 in, 1 out
    assert tuple(state["dec1_conv.wr"].shape) == (64, 32, 5, 2)
    assert tuple(state["enc0_conv.wr"].shape) == (4, 1, 5, 2)
    _assert_trees_equal(flax_from_torch_state(state), variables)
    model = dccrnet.DCCRNet(cfg)
    model.load_state_dict(state, strict=True)
    _assert_trees_equal(flax_from_torch_state(model.state_dict()), variables)


def test_make_model_dccrnet_device():
    cfg = DCCRNConfig(stft=STFTConfig(window="sqrthann"), **TINY)
    model = make_model(cfg, device="cpu")
    assert isinstance(model, dccrnet.DCCRNet) and not model.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_model(cfg)  # the card by default
    with pytest.raises(ValueError, match="dccrnet"):
        dccrnet.DCCRNet(dataclasses.replace(cfg, family="dccrn"))


@pytest.mark.parametrize("layer", ["conv", "conv_transpose", "dense", "cprelu"])
def test_new_complex_layers_match_jax(layer):
    """``ComplexConv2d(causal=False, use_bias=False)``,
    ``ComplexConvTranspose2d(use_bias=False)``, ``ComplexDense`` and
    ``CPReLU`` against the flax layers on the same parameters."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 9, 6) if layer != "dense" else (5, 2, 12)).astype(np.float32)
    if layer == "conv":
        jl = jax_layers.ComplexConv2d(features=8, padding=(2, 0), causal=False, use_bias=False)
        tl = layers.ComplexConv2d(6, 8, padding=(2, 0), causal=False, use_bias=False)
    elif layer == "conv_transpose":
        jl = jax_layers.ComplexConvTranspose2d(features=8, use_bias=False)
        tl = layers.ComplexConvTranspose2d(6, 8, use_bias=False)
    elif layer == "dense":
        jl = jax_layers.ComplexDense(features=7)
        tl = layers.ComplexDense(6, 7)
    else:
        jl = jax_layers.CPReLU()
        tl = layers.CPReLU()
    v = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                     .astype(np.float32), jl.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    if layer in ("conv", "conv_transpose"):
        # the bridge's layouts: [O, I, kh, kw] forward, [I, O, kh, kw] transposed
        name = "enc0_conv" if layer == "conv" else "dec0_conv"
        state = {k.split(".", 1)[1]: t for k, t in
                 torch_state_from_flax({"params": {name: v["params"]}}).items()}
    else:
        state = {k: torch.from_numpy(np.asarray(a)) for k, a in v["params"].items()}
    tl.load_state_dict(state, strict=True)
    got = tl(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_chip_smoke_asteroid_phase_rehearsed_on_the_cpu(smoke, student_pth, tmp_path):
    """chip_smoke.py's phase 23 CLI checks on the CPU: ``import-torch`` of
    the seeded ``.pth``, then ``evaluate --reference-bn`` on the ``.pth``
    and the ``.npz`` (twice), bit for bit alike; and the seeded teacher bundle
    loads through ``load_reference_bundle``."""
    rec = smoke.asteroid_cli_checks(
        student_pth, str(tmp_path), "cpu",
        ("data.synthetic=true", "data.synthetic_size=2", "data.segment=0.5"))
    assert rec["failures"] == [] and rec["bit_equal"] and rec["repeat_bit_equal"]
    assert rec["utterances"] == 2
    assert rec["lstm_launches"] == 0  # no CUDA tensor, no kernel
    teacher = smoke.write_asteroid_pth(str(tmp_path / "teacher.pth"), "DCCRN-CL")
    model, _ = dccrnet.load_reference_bundle(teacher, device="cpu")
    assert model.cfg.kernel_num == (32, 64, 128, 256, 256, 256) and model.cfg.rnn_units == 256
