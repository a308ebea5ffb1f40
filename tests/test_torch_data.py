"""The port's data layer against the JAX package's: the wav codec, the
loader's batch order, and the LibriMix, DNS and ``.npy`` readers on tiny
sets written to ``tmp_path``.  Everything here is numpy on both sides, so
the items must be identical, not close."""

import json
import os
import struct

import numpy as np
import pytest

from speech_enhancement_clskd_tpu.data import dns as jax_dns
from speech_enhancement_clskd_tpu.data import librimix as jax_librimix
from speech_enhancement_clskd_tpu.data import loader as jax_loader
from speech_enhancement_clskd_tpu.data import npy_dataset as jax_npy
from speech_enhancement_clskd_tpu.data import wav as jax_wav
from speech_enhancement_clskd_tpu_torch.data import dns, librimix, loader, npy_dataset, wav
from torch_oracle import one_cpu_thread

SR = 16000


def _noise(rng, *shape):
    return np.clip(0.3 * rng.standard_normal(shape), -1, 1).astype(np.float32)


def _write_raw(path, samples: bytes, fmt: int, n_ch: int, bits: int, rate: int = SR):
    """A RIFF/WAVE file with an odd-sized extra chunk before ``data``."""
    block = n_ch * bits // 8
    body = b"fmt " + struct.pack("<IHHIIHH", 16, fmt, n_ch, rate, rate * block, block, bits)
    body += b"LIST" + struct.pack("<I", 3) + b"abc\x00"  # odd size, padded
    body += b"data" + struct.pack("<I", len(samples)) + samples
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_pcm16_round_trip_matches_jax(tmp_path, channels):
    rng = np.random.default_rng(channels)
    x = _noise(rng, 1001) if channels == 1 else _noise(rng, 1001, channels)
    port_path, jax_path = tmp_path / "port.wav", tmp_path / "jax.wav"
    wav.write_wav(str(port_path), x, SR)
    jax_wav.write_wav(str(jax_path), x, SR)
    assert port_path.read_bytes() == jax_path.read_bytes()
    got, rate = wav.read_wav(str(port_path))
    want, want_rate = jax_wav.read_wav(str(port_path))
    assert rate == want_rate == SR
    _same(got, want)
    # PCM16 quantization: within half a step of 1/32767 scaling
    assert np.abs(got - x).max() <= 1.5 / 32767


@pytest.mark.parametrize("kind", ["pcm32", "float32"])
def test_wav_reads_pcm32_and_float32_as_jax(tmp_path, kind):
    rng = np.random.default_rng(7)
    x = _noise(rng, 777, 2)
    if kind == "pcm32":
        raw, fmt = (x * 2**31 * 0.99).astype("<i4").tobytes(), 1
    else:
        raw, fmt = x.astype("<f4").tobytes(), 3
    path = str(tmp_path / f"{kind}.wav")
    _write_raw(path, raw, fmt, 2, 32)
    got, want = wav.read_wav(path), jax_wav.read_wav(path)
    _same(got, want)
    if kind == "float32":
        np.testing.assert_array_equal(got[0], x)


def test_wav_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX" + b"\x00" * 40)
    with pytest.raises(ValueError):
        wav.read_wav(str(bad))
    pcm8 = str(tmp_path / "pcm8.wav")
    _write_raw(pcm8, b"\x00" * 10, 1, 1, 8)
    for reader in (wav.read_wav, jax_wav.read_wav):
        with pytest.raises(ValueError):
            reader(pcm8)


class _Indexed:
    """Items that name their own index: (mix [T], sources [1, T])."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        mix = np.full(3, i, np.float32)
        return mix, mix[None] * 2


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("seed,epochs", [(0, (0, 1, 2)), (3, (0, 5)), (1234, (7,))])
def test_loader_order_matches_jax(seed, epochs, drop_last):
    ds = _Indexed(23)
    for batch_size in (4, 5):
        port = loader.make_loader(ds, batch_size, shuffle=True, drop_last=drop_last, seed=seed)
        ref = jax_loader.make_loader(ds, batch_size, shuffle=True, drop_last=drop_last,
                                     seed=seed)
        assert len(port) == len(ref)
        for epoch in epochs:
            port.epoch = ref.epoch = epoch
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(ref)
            for g, w in zip(got, want):
                _same(g, w)
            assert port.epoch == ref.epoch == epoch + 1


def test_loader_unshuffled_keeps_order_and_drops_the_tail():
    ds = _Indexed(10)
    port = list(loader.make_loader(ds, 4, shuffle=False))
    ref = list(jax_loader.make_loader(ds, 4, shuffle=False))
    assert len(port) == len(ref) == 2
    for g, w in zip(port, ref):
        _same(g, w)
    np.testing.assert_array_equal(port[1][0][:, 0], [4, 5, 6, 7])


def _librimix_set(root, split="dev", n=6, lengths=(12000, 4000, 20000, 16000, 9000, 16001)):
    """A LibriMix-style directory: wavs plus the manifests of every task."""
    rng = np.random.default_rng(11)
    d = root / split
    d.mkdir()
    rows = []
    for i in range(n):
        paths = {}
        for col in ("mixture", "source_1", "source_2", "noise"):
            p = str(d / f"{col}_{i}.wav")
            wav.write_wav(p, _noise(rng, lengths[i]), SR)
            paths[col] = p
        rows.append(paths)
    for task, csv_name in (("single", f"mixture_{split}_mix_single.csv"),
                           ("both", f"mixture_{split}_mix_both.csv"),
                           ("clean", f"mixture_{split}_mix_clean.csv")):
        with open(d / csv_name, "w") as f:
            f.write("mixture_ID,mixture_path,source_1_path,source_2_path,noise_path,length\n")
            for i, r in enumerate(rows):
                f.write(f"id{i}_{task},{r['mixture']},{r['source_1']},{r['source_2']},"
                        f"{r['noise']},{lengths[i]}\n")
    return str(d)


@pytest.mark.parametrize("task,n_src,segment,seed,return_id", [
    ("enh_single", 1, 0.5, 0, False),
    ("enh_single", 1, 1.0, 5, True),
    ("sep_clean", 2, 0.5, 2, False),
    ("sep_noisy", 2, None, 0, True),
    ("enh_both", 1, 0.25, 9, False),
])
def test_librimix_items_match_jax(tmp_path, task, n_src, segment, seed, return_id):
    d = _librimix_set(tmp_path)
    kw = dict(task=task, sample_rate=SR, n_src=n_src, segment=segment, return_id=return_id,
              seed=seed)
    port, ref = librimix.LibriMixDataset(d, **kw), jax_librimix.LibriMixDataset(d, **kw)
    assert len(port) == len(ref) > 0
    assert port.csv_path == ref.csv_path
    for i in range(len(ref)):
        _same(port[i], ref[i])


def test_librimix_falls_back_to_any_manifest(tmp_path):
    d = _librimix_set(tmp_path, split="custom")
    os.remove(os.path.join(d, "mixture_custom_mix_single.csv"))
    port = librimix.LibriMixDataset(d, segment=0.5)
    ref = jax_librimix.LibriMixDataset(d, segment=0.5)
    assert port.csv_path == ref.csv_path and len(port) == len(ref) > 0
    _same(port[0], ref[0])


def _dns_fileid_set(root):
    rng = np.random.default_rng(13)
    for sub in ("noisy", "clean"):
        (root / sub).mkdir()
    for fid, n in ((3, 9000), (10, 20000), (1, 16000), (7, 4000)):
        wav.write_wav(str(root / "noisy" / f"book_x_snr5_fileid_{fid}.wav"), _noise(rng, n), SR)
        wav.write_wav(str(root / "clean" / f"clean_fileid_{fid}.wav"), _noise(rng, n + 17), SR)
    wav.write_wav(str(root / "noisy" / "stray_fileid_99.wav"), _noise(rng, 100), SR)
    return str(root)


def _dns_manifest_set(root):
    rng = np.random.default_rng(17)
    entries = []
    for i, n in enumerate((12000, 3000, 16000)):
        wav.write_wav(str(root / f"m{i}.wav"), _noise(rng, n), SR)
        wav.write_wav(str(root / f"c{i}.wav"), _noise(rng, n), SR)
        entries.append({"mix": f"m{i}.wav", "clean": str(root / f"c{i}.wav"), "id": f"u{i}"})
    with open(root / "file_infos.json", "w") as f:
        json.dump(entries, f)
    return str(root)


@pytest.mark.parametrize("layout", ["fileid", "manifest"])
@pytest.mark.parametrize("segment,seed,return_id", [(0.5, 0, False), (1.0, 4, True),
                                                     (None, 0, False)])
def test_dns_items_match_jax(tmp_path, layout, segment, seed, return_id):
    root = (_dns_fileid_set if layout == "fileid" else _dns_manifest_set)(tmp_path)
    kw = dict(sample_rate=SR, segment=segment, return_id=return_id, seed=seed)
    port, ref = dns.DNSDataset(root, **kw), jax_dns.DNSDataset(root, **kw)
    assert port.pairs == ref.pairs
    for i in range(len(ref)):
        _same(port[i], ref[i])


def test_npy_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(19)
    pairs = np.empty(3, dtype=object)
    for i in range(3):
        pairs[i] = [_noise(rng, 100 + i).astype(np.float64), _noise(rng, 100 + i)]
    np.save(tmp_path / "train.npy", pairs, allow_pickle=True)
    port = npy_dataset.WaveDataset(str(tmp_path / "train.npy"))
    ref = jax_npy.WaveDataset(str(tmp_path / "train.npy"))
    assert len(port) == len(ref) == 3
    for i in range(3):
        _same(port[i], ref[i])

    test_blob = np.empty((2, 2), dtype=object)
    for t in range(2):
        for s in range(2):
            split = np.empty(2, dtype=object)
            for i in range(2):
                split[i] = [_noise(rng, 50), _noise(rng, 50)]
            test_blob[t, s] = split
    np.save(tmp_path / "test.npy", test_blob, allow_pickle=True)
    port = npy_dataset.WaveDatasetForTest(str(tmp_path / "test.npy"), 1, 0)
    ref = jax_npy.WaveDatasetForTest(str(tmp_path / "test.npy"), 1, 0)
    for i in range(2):
        _same(port[i], ref[i])
