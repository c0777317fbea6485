"""The port's I/O against lsm_tpu's on the CPU: WAV decoding and batch
loading (lsm_tpu's NumPy path, use_native=False), the mu-law and PCM16
wires, the corpus walk and writer, the stage artifacts and sharded spike
datasets, each way round. Everything here is exact: arrays bit-equal,
errors and warnings equal as text."""

import json
import struct

import numpy as np
import pytest

from lsm_tpu.io import artifacts as jart
from lsm_tpu.io import dataset as jds
from lsm_tpu.io import sharded as jsh
from lsm_tpu.io import wav as jwav
from lsm_tpu.ops import ulaw as julaw

from lsm_tpu_torch.io import artifacts as tart
from lsm_tpu_torch.io import dataset as tds
from lsm_tpu_torch.io import sharded as tsh
from lsm_tpu_torch.io import wav as twav
from lsm_tpu_torch.ops import ulaw as tulaw


def _riff(fmt_code, channels, rate, bits, payload, extensible=False):
    """A RIFF/WAVE file of any format; extensible=True writes
    WAVE_FORMAT_EXTENSIBLE with fmt_code as the SubFormat GUID's code."""
    block = channels * bits // 8
    if extensible:
        guid = struct.pack("<H", fmt_code) + b"\x00\x00" + b"\x10" * 12
        body = struct.pack("<HHIIHH", 0xFFFE, channels, rate, rate * block, block, bits) \
            + struct.pack("<HHI", 22, bits, 3) + guid
    else:
        body = struct.pack("<HHIIHH", fmt_code, channels, rate, rate * block, block, bits)
    return (b"RIFF" + struct.pack("<I", 20 + len(body) + len(payload)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(body)) + body
            + b"data" + struct.pack("<I", len(payload)) + payload)


def _payloads(rng, n=12000):
    """(name, file bytes) of every format the decoder takes, and broken ones."""
    x = np.clip(rng.standard_normal(n) * 0.3, -1, 1)
    i24 = (x * 8388607).astype(np.int32)
    b24 = np.stack([i24 & 0xFF, (i24 >> 8) & 0xFF, (i24 >> 16) & 0xFF], -1).astype(np.uint8)
    stereo = np.stack([x, x[::-1]], -1)
    pcm16 = (x * 32767).astype("<i2").tobytes()
    return [
        ("pcm8", _riff(1, 1, 16000, 8, ((x * 127) + 128).astype(np.uint8).tobytes())),
        ("pcm16", _riff(1, 1, 16000, 16, pcm16)),
        ("pcm24", _riff(1, 1, 16000, 24, b24.tobytes())),
        ("pcm32", _riff(1, 1, 16000, 32, (x * 2147483647).astype("<i4").tobytes())),
        ("float32", _riff(3, 1, 16000, 32, x.astype("<f4").tobytes())),
        ("float64", _riff(3, 1, 16000, 64, x.astype("<f8").tobytes())),
        ("ext_float32", _riff(3, 1, 16000, 32, x.astype("<f4").tobytes(), extensible=True)),
        ("stereo_22050", _riff(1, 2, 22050, 16, (stereo * 32767).astype("<i2").tobytes())),
        ("long_8k", _riff(1, 1, 8000, 16, np.tile(np.frombuffer(pcm16, "<i2"), 2).tobytes())),
        ("truncated", _riff(1, 1, 16000, 16, pcm16)[:30]),
        ("cut_data", _riff(1, 1, 16000, 16, pcm16)[:5000]),
        ("cut_odd", _riff(1, 1, 16000, 16, pcm16)[:5001]),
        ("flac", b"fLaC" + bytes(60)),
        ("ogg", b"OggS" + bytes(60)),
        ("pcm12", _riff(1, 1, 16000, 12, pcm16)),
    ]


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    paths = []
    for name, data in _payloads(np.random.default_rng(3)):
        p = d / f"{name}.wav"
        p.write_bytes(data)
        paths.append(p)
    return paths


def _outcome(fn, *args):
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return None, (type(e).__name__, str(e))


def test_decode_and_load_wav_bit_equal(wav_files):
    """decode_wav and load_wav on every format, the resampled and the
    broken files included: the same samples and rate, or the same error."""
    for p in wav_files:
        data = p.read_bytes()
        (t, terr), (j, jerr) = _outcome(twav.decode_wav, data), _outcome(jwav.decode_wav, data)
        assert terr == jerr, p.name
        if t is not None:
            np.testing.assert_array_equal(t[0], j[0], err_msg=p.name)
            assert t[0].dtype == j[0].dtype and t[1] == j[1]
            for duration in (None, 1.0):
                np.testing.assert_array_equal(twav.load_wav(p, 16000, duration),
                                              jwav.load_wav(p, 16000, duration), err_msg=p.name)


@pytest.mark.parametrize("dtype", ["float32", "int16", "ulaw"])
def test_load_audio_batch_bit_equal(wav_files, dtype):
    t_batch, t_kept, t_err = twav.load_audio_batch(wav_files, 16000, 1.0, use_native=False,
                                                   dtype=dtype)
    j_batch, j_kept, j_err = jwav.load_audio_batch(wav_files, 16000, 1.0, use_native=False,
                                                   dtype=dtype)
    np.testing.assert_array_equal(t_batch, j_batch)
    assert t_batch.dtype == j_batch.dtype and t_batch.shape[1] == 16000
    assert t_kept == j_kept and t_err == j_err
    assert len(t_err) == 5 and {p.name for p, _ in t_err} == \
        {"truncated.wav", "cut_odd.wav", "flac.wav", "ogg.wav", "pcm12.wav"}


def test_resamplers_bit_equal():
    x = np.random.default_rng(5).standard_normal(3001).astype(np.float32)
    for src, dst in ((22050, 16000), (8000, 16000), (16000, 16000), (44100, 16000)):
        np.testing.assert_array_equal(twav.resample_sinc(x, src, dst), jwav.resample_sinc(x, src, dst))
        np.testing.assert_array_equal(twav.resample_linear(x, src, dst),
                                      jwav.resample_linear(x, src, dst))


def test_container_sniffing_equal():
    heads = [b"fLaC", b"OggS", b"ID3\x04", b"\xff\xfb\x90\x00", b"FORM\x00\x00\x00\x2eAIFF",
             b"\x00\x00\x00\x20ftypM4A ", b"\xff\xff\xff\xff", b"\xff\xe1\x00\x00", bytes(4)]
    for h in heads:
        head = h + bytes(12)
        assert twav.sniff_container(head) == jwav.sniff_container(head)
        assert twav.unsupported_container_error(head) == jwav.unsupported_container_error(head)


def test_pcm16_and_ulaw_wires_bit_equal_on_every_int16():
    pcm = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    np.testing.assert_array_equal(tulaw.encode_ulaw(pcm), julaw.encode_ulaw(pcm))
    f = np.concatenate([pcm.astype(np.float32) / 32768.0,
                        np.float32([-1.5, -1.0, 0.99999, 1.0, 1.5])])[None, :]
    np.testing.assert_array_equal(twav.to_pcm16_wire(f), jwav.to_pcm16_wire(f))
    np.testing.assert_array_equal(tulaw.encode_ulaw_f32(f), julaw.encode_ulaw_f32(f))
    with pytest.raises(TypeError):
        tulaw.encode_ulaw(pcm.astype(np.int32))


def test_synthetic_corpus_writes_the_same_bytes(tmp_path):
    tds.write_synthetic_corpus(tmp_path / "t", ["yes", "no"], n_per_class=3, seed=7)
    jds.write_synthetic_corpus(tmp_path / "j", ["yes", "no"], n_per_class=3, seed=7)
    names = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*.wav"))
    assert names == sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.wav"))
    assert len(names) == 6
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


@pytest.mark.parametrize("cap", [1000, 2])
def test_index_speech_commands_equal(tmp_path, cap):
    tds.write_synthetic_corpus(tmp_path, ["yes", "no"], n_per_class=3)
    (tmp_path / "up").mkdir()                          # an empty glob
    (tmp_path / "no" / "notes.txt").write_text("not a wav")
    commands = ["yes", "no", "missing", "up"]
    t = tds.index_speech_commands(tmp_path, commands, cap)
    j = jds.index_speech_commands(tmp_path, commands, cap)
    assert t.files == j.files and len(t.files) == 2 * min(cap, 3)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.labels.dtype == j.labels.dtype == np.int32
    assert t.warnings == j.warnings and len(t.warnings) == 2
    assert list(t.class_names) == list(j.class_names)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stage_artifacts_load_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(2)
    save, load = (tart, jart) if writer == "port" else (jart, tart)
    spikes = (rng.random((5, 8, 16)) < 0.3).astype(np.uint8)
    labels = np.arange(5, dtype=np.int32)
    save.save_spike_dataset(tmp_path / "s.npz", save.SpikeDataset(spikes, labels))
    ds = load.load_spike_dataset(tmp_path / "s.npz")
    np.testing.assert_array_equal(ds.x_spikes, spikes)
    np.testing.assert_array_equal(ds.y_labels, labels)
    for lvd in (None, 2.5):
        art = save.FeatureArtifact(rng.random((4, 6)).astype(np.float32), labels[:4],
                                   rng.random((1, 6)).astype(np.float32), labels[4:],
                                   "rate", lvd)
        save.save_features(tmp_path / "f.npz", art)
        got = load.load_features(tmp_path / "f.npz")
        for a, b in zip(got[:4], art[:4]):
            np.testing.assert_array_equal(a, b)
        assert got.feature_set == "rate" and got.leak_variance_divisor == lvd
    with pytest.raises(FileNotFoundError):
        load.load_spike_dataset(tmp_path / "nope.npz")
    with pytest.raises(FileNotFoundError):
        load.load_features(tmp_path / "nope.npz")


def test_load_features_reference_format_pickled_none(tmp_path, caplog):
    """The reference scripts save leak_variance_divisor=None as a pickled
    object: read with a warning, as lsm_tpu reads it."""
    x = np.random.default_rng(1).standard_normal((8, 10)).astype(np.float32)
    y = np.arange(8) % 2
    p = tmp_path / "ref_features.npz"
    np.savez_compressed(p, X_train_features=x, y_train=y, X_test_features=x, y_test=y,
                        feature_set="original", leak_variance_divisor=None)
    t, j = tart.load_features(p), jart.load_features(p)
    assert t.leak_variance_divisor is None and j.leak_variance_divisor is None
    np.testing.assert_array_equal(t.x_train, j.x_train)
    assert t.feature_set == j.feature_set == "original"
    assert "pickled object" in caplog.text


def _shard_case(rng, n=31):
    x = (rng.random((n, 4, 16)) < 0.3).astype(np.uint8)
    y = rng.integers(0, 3, n).astype(np.int32)
    meta = {"frontend": {"n_filters": 4}, "class_names": ["a", "b", "c"]}
    return x, y, meta


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("compress", [True, False])
def test_shards_read_in_the_other_package(tmp_path, writer, compress):
    x, y, meta = _shard_case(np.random.default_rng(4))
    w_mod, r_mod = (tsh, jsh) if writer == "port" else (jsh, tsh)
    w = w_mod.ShardedSpikeDatasetWriter(tmp_path, shard_size=7, compress=compress,
                                        fingerprint="fp", meta=meta)
    w.append(x[:10], y[:10], np.arange(10))
    w.append(x[10:], y[10:], np.arange(10, 31))
    manifest = w.close()
    ds = r_mod.ShardedSpikeDataset(tmp_path)
    assert ds.num_samples == 31 and ds.meta == meta and not ds.is_partial
    assert ds.total_spikes == int(x.sum()) and ds.row_shape == (4, 16)
    assert json.loads((tmp_path / "manifest.json").read_text()) == manifest
    assert len(manifest["shards"]) == 5
    full = ds.load_all()
    np.testing.assert_array_equal(full.x_spikes, x)
    np.testing.assert_array_equal(full.y_labels, y)
    batches = list(ds.iter_batches(9))
    assert [len(b.y_labels) for b in batches] == [9, 9, 9, 4]
    np.testing.assert_array_equal(np.concatenate([b.x_spikes for b in batches]), x)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_resume_across_packages(tmp_path, writer):
    """A run killed after two shards resumes in the other package after its
    last journaled file; another fingerprint starts afresh."""
    x, y, meta = _shard_case(np.random.default_rng(6))
    first, second = (tsh, jsh) if writer == "port" else (jsh, tsh)
    w = first.ShardedSpikeDatasetWriter(tmp_path, shard_size=8, fingerprint="fp", meta=meta)
    w.append(x[:20], y[:20], np.arange(20))          # 2 shards flushed, 4 rows buffered
    (tmp_path / "journal.jsonl").open("a").write('{"file": "shard_0000')   # torn append

    part = second.ShardedSpikeDataset(tmp_path)
    assert part.is_partial and part.num_samples == 16 and part.meta == meta
    np.testing.assert_array_equal(part.load_all().x_spikes, x[:16])

    w2 = second.ShardedSpikeDatasetWriter(tmp_path, shard_size=8, resume=True, fingerprint="fp",
                                          meta={"class_names": ["x"]})
    assert w2.resume_file_index == 15 and len(w2.completed_shards()) == 2
    assert w2.meta == meta                          # the stored meta wins
    w2.append(x[16:], y[16:], np.arange(16, 31))
    w2.close()
    for mod in (tsh, jsh):
        full = mod.ShardedSpikeDataset(tmp_path).load_all()
        np.testing.assert_array_equal(full.x_spikes, x)
        np.testing.assert_array_equal(full.y_labels, y)

    w3 = second.ShardedSpikeDatasetWriter(tmp_path, shard_size=8, resume=True, fingerprint="other")
    assert w3.resume_file_index == -1 and w3.completed_shards() == []


def test_journal_missing_shard_ends_the_valid_prefix(tmp_path):
    x, y, _ = _shard_case(np.random.default_rng(8), n=24)
    w = tsh.ShardedSpikeDatasetWriter(tmp_path, shard_size=8)
    w.append(x, y)                                   # 3 shards, no close()
    (tmp_path / "shard_00001.npz").unlink()
    for mod in (tsh, jsh):
        ds = mod.ShardedSpikeDataset(tmp_path)
        assert ds.num_samples == 8
        np.testing.assert_array_equal(ds.load_all().x_spikes, x[:8])
    with pytest.raises(FileNotFoundError):
        tsh.ShardedSpikeDataset(tmp_path / "absent")
