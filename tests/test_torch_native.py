"""The port's native C++ WAV decoder (csrc/wavio.cpp, io/native.py) against
lsm_tpu's native decoder (the same source and flags: bit-equal) and
against the port's NumPy decoder at tests/test_native.py's rule: the int16
and mu-law wires bit-equal, float32 within 1e-6 (1e-5 where resampled),
broken files skipped alike. Every format of tests/test_torch_io.py's
payloads runs. One file parts the two decoders, in lsm_tpu as here: a data
chunk cut at an odd byte, which the native decoder reads up to its last
whole sample and the NumPy decoder refuses."""

import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile

from lsm_tpu.io import native as jnative

from lsm_tpu_torch.io import native as tnative
from lsm_tpu_torch.io import wav as twav
from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.ops.ulaw import encode_ulaw
from test_torch_io import _payloads

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is missing: the native decoder builds with it")

WIRES = ["float32", "int16", "ulaw"]
BROKEN = {"truncated.wav", "flac.wav", "ogg.wav", "pcm12.wav"}
ODD = "cut_odd.wav"          # native: decoded; NumPy: refused
RESAMPLED = {"stereo_22050.wav", "long_8k.wav"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every payload format, then mono PCM16 files at the target rate (the
    memcpy fast path; one short, so padded) and one PCM16 file at 8 kHz."""
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(11)
    paths = []
    for name, data in _payloads(rng):
        p = d / f"{name}.wav"
        p.write_bytes(data)
        paths.append(p)
    for i, n in enumerate((16000, 12000, 20000)):
        p = d / f"raw{i}.wav"
        scipy.io.wavfile.write(p, 16000, (rng.standard_normal(n) * 8000).astype(np.int16))
        paths.append(p)
    p = d / "r8k.wav"
    scipy.io.wavfile.write(p, 8000, (rng.standard_normal(8000) * 8000).astype(np.int16))
    paths.append(p)
    return paths


def test_the_source_is_lsm_tpus_below_its_header():
    body = re.compile(r"#include <atomic>.*", re.S)
    port = body.search((REPO / "lsm_tpu_torch" / "csrc" / "wavio.cpp").read_text()).group(0)
    ref = body.search((REPO / "native" / "wavio.cpp").read_text()).group(0)
    assert port == ref


def test_it_builds_and_loads():
    assert tnative.available(), tnative.unavailable_reason()
    assert tnative.supports_i16() and tnative.supports_ulaw()
    lib = _build.build_wavio()
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libwavio_")
    assert _build.build_wavio() == lib                      # keyed, not rebuilt


@pytest.mark.parametrize("wire", WIRES)
def test_bit_equal_to_lsm_tpus_native_decoder(files, wire):
    if not jnative.available():
        pytest.skip("lsm_tpu's native decoder does not build here")
    t, t_kept, t_err = tnative.load_audio_batch(files, 16000, 1.0, dtype=wire)
    j, j_kept, j_err = jnative.load_audio_batch(files, 16000, 1.0, dtype=wire)
    np.testing.assert_array_equal(t, j)
    assert t.dtype == j.dtype and t_kept == j_kept
    assert [(p.name, m) for p, m in t_err] == [(p.name, m) for p, m in j_err]


@pytest.mark.parametrize("wire", WIRES)
def test_matches_the_numpy_decoder(files, wire):
    nat, kept_n, err_n = tnative.load_audio_batch(files, 16000, 1.0, dtype=wire)
    ref, kept_r, err_r = twav.load_audio_batch(files, 16000, 1.0, use_native=False, dtype=wire)
    assert {p.name for p, _ in err_n} == BROKEN
    assert {p.name for p, _ in err_r} == BROKEN | {ODD}
    assert [files[i].name for i in kept_n if i not in kept_r] == [ODD]
    nat = nat[[j for j, i in enumerate(kept_n) if i in kept_r]]
    assert nat.dtype == ref.dtype and nat.shape == ref.shape
    if wire != "float32":
        np.testing.assert_array_equal(nat, ref)
        return
    for row, name in enumerate(files[i].name for i in kept_r):
        atol = 1e-5 if name in RESAMPLED or name == "r8k.wav" else 1e-6
        np.testing.assert_allclose(nat[row], ref[row], atol=atol, rtol=0, err_msg=name)


def test_broken_files_are_named(files):
    _, _, errors = tnative.load_audio_batch(files, 16000, 1.0)
    msgs = {p.name: m for p, m in errors}
    assert "FLAC" in msgs["flac.wav"] and "Ogg" in msgs["ogg.wav"]
    assert msgs["truncated.wav"] == "decode failed"


def test_int16_wire_is_the_raw_samples_and_the_float32_quantized(files):
    raw = [p for p in files if p.name.startswith("raw")]
    f32, _, _ = tnative.load_audio_batch(raw, 16000, 1.0)
    i16, kept, _ = tnative.load_audio_batch(raw, 16000, 1.0, dtype="int16")
    ul, _, _ = tnative.load_audio_batch(raw, 16000, 1.0, dtype="ulaw")
    assert kept == [0, 1, 2]
    np.testing.assert_array_equal(i16, twav.to_pcm16_wire(f32))
    np.testing.assert_array_equal(ul, encode_ulaw(i16))
    for row, p in enumerate(raw):
        samples = scipy.io.wavfile.read(p)[1][:16000]
        np.testing.assert_array_equal(i16[row, :len(samples)], samples)
    assert (i16[1, 12000:] == 0).all() and (ul[1, 12000:] == 0xFF).all()   # padding


def test_load_audio_batch_dispatches_and_falls_back(files, monkeypatch):
    files = [p for p in files if p.name != ODD]
    before = tnative.batches
    a = twav.load_audio_batch(files, 16000, 1.0, dtype="int16")
    assert tnative.batches == before + 1                     # the native decoder ran
    monkeypatch.setattr(tnative, "_load", lambda: None)      # no compiler, no library
    b = twav.load_audio_batch(files, 16000, 1.0, dtype="int16")
    assert tnative.batches == before + 1                     # NumPy decoded
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.load_audio_batch(files, 16000, 1.0)


def test_n_threads_do_not_change_the_bits(files):
    one = tnative.load_audio_batch(files, 16000, 1.0, n_threads=1)[0]
    many = tnative.load_audio_batch(files, 16000, 1.0, n_threads=4)[0]
    np.testing.assert_array_equal(one, many)
