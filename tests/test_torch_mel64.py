"""BASELINE configs[0] (`benchmark/configs/mel64.json`: 64 Slaney mel
filters on a 2048-point STFT) through the port's batch path, against the
benchmark's float64 plain reference (`benchmark/reference/mel.py`, which
computes the DFT and the filterbank itself), and the mel branch's spans
and STFT counter.

Tolerances and why:
  - the dB spectrogram within 1e-3 dB everywhere, as tests/test_torch_mel.py
    holds mel against lsm_tpu: the port's float32 rFFT and filterbank
    product read within ~4e-5 dB of float64 on these utterances, and a
    floor 80 dB below each peak keeps the quietest bins, where float32
    loses most, out of reach;
  - spikes: at most 1e-4 of the entries may differ, and each run of
    differing entries must start where float64's normalized value lies
    within 1e-5 of the threshold or of its hold level (the port's
    normalized values read within ~5e-7 of float64's here): a flip is a
    rounding at a threshold, never another decision;
  - the reservoir's features from the port's spikes and the readout's
    predictions from its features exactly, as
    benchmark/tests/test_bench_reference.py holds the flagship's (the
    reference copies the port's plain twins' arithmetic on the CPU).
On the card (marker `gpu`) the same dB and spike tolerances hold for
cuFFT's rFFT at 256 utterances.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.lib import corpus, model  # noqa: E402
from benchmark.loops import port  # noqa: E402
from benchmark.reference import mel as ref_mel  # noqa: E402
from lsm_tpu_torch import config as tcfg  # noqa: E402
from lsm_tpu_torch.models import reservoir as res  # noqa: E402
from lsm_tpu_torch.models.frontend import featurize_batch, spectrogram_db  # noqa: E402
from lsm_tpu_torch.ops import db as db_ops  # noqa: E402
from lsm_tpu_torch.ops import resample, stft  # noqa: E402

from test_torch_tracing import traced_spans  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
DB_TOL = 1e-3
FLIP_SHARE = 1e-4
NORM_TOL = 1e-5
CONFIG = json.loads((REPO / "benchmark" / "configs" / "mel64.json").read_text())
FCFG = port.frontend_config(CONFIG)


def utterances(kind: str, n: int = 6, seed: int = 11) -> torch.Tensor:
    return torch.as_tensor(corpus.GENERATORS[kind](1, n, seed=seed)[0])


def port_normalized(audio: torch.Tensor) -> torch.Tensor:
    spec = db_ops.minmax_normalize(spectrogram_db(audio, FCFG))
    return resample.zoom_time_axis(spec, FCFG.time_bins)


def assert_flips_at_thresholds(spikes, ref_spikes, ref_norm):
    """spikes (B, C, T * n_thr): few differ, and each run of differing
    entries of one (row, channel, threshold) starts within NORM_TOL of the
    threshold or of its hold level in float64's normalized value."""
    differ = spikes != ref_spikes
    assert float(differ.double().mean()) <= FLIP_SHARE
    n_thr = len(FCFG.spike_thresholds)
    thr = np.sort(np.asarray(FCFG.spike_thresholds, np.float32))[::-1]
    d = differ.view(*differ.shape[:2], -1, n_thr)
    starts = d & ~torch.cat([torch.zeros_like(d[:, :, :1]), d[:, :, :-1]], dim=2)
    for b, c, t, i in starts.nonzero().tolist():
        x = float(ref_norm[b, c, t])
        levels = (float(thr[i]), float(np.float32(thr[i]) - np.float32(FCFG.hysteresis_gap)))
        assert min(abs(x - lv) for lv in levels) <= NORM_TOL, (b, c, t, i, x)


@pytest.mark.parametrize("kind", ["easy", "hard"])
def test_spectrogram_db_is_float64s_within_a_thousandth_of_a_db(kind):
    audio = utterances(kind)
    ref = ref_mel.MelFrontend(CONFIG["frontend"], CPU)
    got = spectrogram_db(audio, FCFG)
    want = ref.spectrogram_db(audio)
    assert got.shape == want.shape == (6, 64, 101) and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= DB_TOL


@pytest.mark.parametrize("kind", ["easy", "hard"])
def test_spikes_differ_only_at_a_threshold(kind):
    audio = utterances(kind, seed=12)
    ref = ref_mel.MelFrontend(CONFIG["frontend"], CPU)
    ref_norm = ref.normalized(audio)
    assert float((port_normalized(audio).double() - ref_norm).abs().max()) <= NORM_TOL
    spikes = featurize_batch(audio, FCFG)
    assert spikes.shape == (6, 64, 400)
    assert_flips_at_thresholds(spikes, ref.batch(audio), ref_norm)


def test_reservoir_and_readout_from_the_ports_outputs_equal_the_reference():
    cfg = json.loads(json.dumps(CONFIG))
    cfg["reservoir"].update(num_neurons=128, num_output_neurons=64, small_world_k=16)
    w = model.make(cfg, 2**32 + 5, CPU)
    assert tuple(w["w_in"].shape) == (128, 128)          # 64 channels padded to 128 rows
    audio = utterances("easy", n=4, seed=13)
    prog = port.Batch(cfg, w)
    out = prog.step(audio)
    ref = ref_mel.Batch(cfg, w, CPU, rows=3)
    feats = ref.features(out["spikes"])
    torch.testing.assert_close(feats, out["features"], rtol=0, atol=0)
    torch.testing.assert_close(feats, res.extract_features(prog.reservoir, out["spikes"],
                                                           prog.keys), rtol=0, atol=0)
    assert torch.equal(torch.argmax(ref.logits(out["features"]), -1), out["preds"])
    rec, inp = ref.fired(out["spikes"])
    assert rec > 0 and inp == float(out["spikes"].sum())


@pytest.mark.parametrize("filterbank", ["mel", "gammatone"])
def test_the_mel_branch_opens_its_two_spans_inside_the_spectrograms(filterbank):
    cfg = FCFG if filterbank == "mel" else tcfg.FrontendConfig(n_filters=16)
    audio = utterances("easy", n=2)
    want = featurize_batch(audio, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            assert torch.equal(featurize_batch(audio, cfg), want)
    spans = traced_spans(prof)
    inner = [(n, p) for n, _, _, p in spans if n in ("lsm.frontend.stft", "lsm.frontend.mel")]
    if filterbank == "gammatone":
        assert inner == []
    else:
        assert inner == [("lsm.frontend.stft", "lsm.frontend.spectrogram"),
                         ("lsm.frontend.mel", "lsm.frontend.spectrogram")] * 2


@pytest.mark.parametrize("lead,samples,n_fft,hop", [((3,), 16000, 2048, 160),
                                                    ((2, 2), 4000, 512, 100),
                                                    ((1,), 1000, 401, 160)])
def test_stft_counts_advance_by_the_shapes(lead, samples, n_fft, hop):
    audio = torch.randn(*lead, samples)
    rows = int(np.prod(lead))
    n_frames = 1 + (samples + 2 * (n_fft // 2) - n_fft) // hop
    before = dict(stft.counts)
    power = stft.stft_power(audio, n_fft, hop)
    assert power.shape == (*lead, n_fft // 2 + 1, n_frames)
    padded = rows * (samples + 2 * (n_fft // 2))
    frames = rows * n_frames
    spectrum = frames * (n_fft // 2 + 1)
    assert stft.counts["frames"] - before.get("frames", 0) == frames
    assert stft.counts["bytes"] - before.get("bytes", 0) == (
        4 * padded + 4 * frames * n_fft + 8 * spectrum + 3 * 4 * spectrum)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's rFFT is cuFFT")
    return torch.device("cuda")


@pytest.mark.gpu
def test_on_the_card_the_mel_front_end_holds_the_same_tolerances(card):
    audio = torch.as_tensor(corpus.synthetic_audio_batch(64, 4, seed=21)[0]).to(card)
    ref = ref_mel.MelFrontend(CONFIG["frontend"], card)
    got = spectrogram_db(audio, FCFG)
    assert float((got.double() - ref.spectrogram_db(audio)).abs().max()) <= DB_TOL
    assert_flips_at_thresholds(featurize_batch(audio, FCFG), ref.batch(audio),
                               ref.normalized(audio))
