"""The cells mel64.batch (loops/batch_mel.py over reference/mel.py) and
scaled10k.batch (loops/batch.py on the block-sparse reservoir) without a
card, at a tiny size on the CPU, as test_bench_faults.py runs the others:
a sound program comes out correct, the control and each planted fault do
not; a program that keeps no STFT frame count fails before its set-up,
and one whose window transformed other frames than its steps fails; a
traced run reports what it can read without a card, and every per-layer
reader the cell lists reads a number once the trace holds device time;
the counts of the mel spectrogram and of B5 against hand counts."""

import json
import math

import pytest
import torch
from test_bench_faults import BENCH, REPO, result, tiny_root  # noqa: F401  (the tiny tree)
from test_bench_imports import JAX_STACK, loaded_top_levels

from benchmark import run
from benchmark.lib import load_module, roofline, spans
from benchmark.loops import port


@pytest.fixture(scope="module")
def mel_root(tiny_root):  # noqa: F811
    """The tiny tree with mel64 at 16 filters and 256 neurons, and its
    traffic at 12 utterances a step."""
    cfg = json.loads((BENCH / "configs" / "mel64.json").read_text())
    cfg["frontend"]["n_filters"] = 16
    cfg["reservoir"].update(num_neurons=256, num_output_neurons=64, small_world_k=52)
    (tiny_root / "configs" / "mel64.json").write_text(json.dumps(cfg))
    tb = json.loads((BENCH / "traffic" / "batch-mel64.json").read_text())
    tb.update(pool_parts=2, per_class=3, utterances_per_step=12, workers=1, max_traced_steps=20)
    (tiny_root / "traffic" / "batch-mel64.json").write_text(json.dumps(tb))
    return tiny_root


CELLS = ["mel64.batch", "scaled10k.batch"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(mel_root, capsys, cell):
    line = result(capsys, mel_root, cell)
    assert line["correct"] is True
    assert set(line["checks"]) == {"spike_flips", "feature_gap_median", "pred_mismatch"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(mel_root, capsys, cell):
    assert result(capsys, mel_root, cell, control=1)["correct"] is False


_step = port.Batch.step


def _answer_altered(self, audio, events=None):
    out = _step(self, audio, events)
    return {**out, "preds": (out["preds"] + 1) % 4}


def _half_zeroed(self, audio, events=None):
    half = audio.shape[0] // 2
    return _step(self, torch.cat([audio[:half], torch.zeros_like(audio[half:])]), events)


@pytest.mark.parametrize("fault", [_answer_altered, _half_zeroed], ids=lambda f: f.__name__)
def test_fault_is_not_correct(mel_root, capsys, monkeypatch, fault):
    monkeypatch.setattr(port.Batch, "step", fault)
    assert result(capsys, mel_root, "mel64.batch")["correct"] is False


def test_a_program_without_the_frame_count_fails_before_its_set_up(mel_root, monkeypatch):
    from lsm_tpu_torch.ops import stft

    monkeypatch.delattr(stft, "counts")
    made = []
    monkeypatch.setattr(port.Batch, "__init__", lambda *a, **k: made.append(1))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    with pytest.raises(RuntimeError, match="counts no STFT frames"):
        run.main(["--workload", "mel64.batch", "--seed", "7", "--seconds", "0.3"],
                 bench=bench, root=mel_root, require_cuda=False)
    assert made == []


def test_a_window_that_skips_its_stft_fails(mel_root, monkeypatch):
    seen = {}

    def replayed(self, audio, events=None):
        key = audio.data_ptr()
        if key not in seen:
            seen[key] = _step(self, audio, events)
        return seen[key]

    monkeypatch.setattr(port.Batch, "step", replayed)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    with pytest.raises(RuntimeError, match="STFT frames in the window"):
        run.main(["--workload", "mel64.batch", "--seed", "7", "--seconds", "0.3"],
                 bench=bench, root=mel_root, require_cuda=False)


def with_device_time(run_dict: dict) -> dict:
    """The run as if its window held device time: every span of the
    reduction 1 ms a step, each kernel the counts name 1 ms a step, the
    card busy nine tenths of the window."""
    tr, steps = run_dict["trace"], run_dict["steps"]
    red = tr["spans"]
    red["device"] = True
    for v in red["spans"].values():
        v["dev_s"] = v["dev_s_total"] = 1e-3 * steps
    names = {n for k in ("b1", "b2", "b5") for n in roofline.counts(k).KERNELS}
    tr["device_s_by_name"] = {f"void {n}(...)": 1e-3 * steps for n in names}
    tr["busy_s"] = 0.9 * tr["window_s"]
    return run_dict


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_every_metric_its_lists_name(mel_root, capsys, monkeypatch, cell):
    seen = []
    of_run = spans.of_run

    def keep(run_dict):
        seen.append(run_dict)
        return of_run(run_dict)

    monkeypatch.setattr(spans, "of_run", keep)
    line = result(capsys, mel_root, cell, trace=1)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    listed = [m["name"] for m in run.cell_metrics(bench, cell, "per_layer")]
    assert {"frontend_ms.batch", "reservoir_ms.batch", "readout_ms.batch",
            "device_idle.batch"} <= set(line["metrics"]) <= set(listed)
    assert "breakdown" in line and line["device"]["window_s"] > 0
    faked = with_device_time(seen[0])
    for name in listed:
        value = load_module(mel_root / "metrics" / f"{name}.py").read(faked)
        assert value is not None and math.isfinite(value), name


def test_the_lists_name_the_kernels_each_cell_runs():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    mel = {m["name"] for m in run.cell_metrics(bench, "mel64.batch", "per_layer")}
    sparse = {m["name"] for m in run.cell_metrics(bench, "scaled10k.batch", "per_layer")}
    assert {"stft_ms.batch", "mel_ms.batch", "melspec_roofline", "b2_roofline",
            "mfu.step.batch"} <= mel
    assert not mel & {"spectrogram_ms.batch", "b1_roofline", "mfu.batch", "b5_roofline"}
    assert {"b1_roofline", "b5_roofline", "spectrogram_ms.batch", "mfu.step.batch"} <= sparse
    assert not sparse & {"b2_roofline", "mfu.batch", "stft_ms.batch", "melspec_roofline"}


def test_the_mel_spectrograms_count_by_hand():
    shape = {"filterbank": "mel", "frames": 3, "n_fft": 8, "mel_taps": 5, "channels": 2}
    run_dict = {"cell_kind": "batch", "utterances": 2, "samples": 10, "shape": shape}
    # per frame: window 8, rFFT 2.5 * 8 * 3 = 60, power 3 * 5 bins, taps 2 * 5, dB 5 * 2
    assert roofline.counts("melspec").work(run_dict) == {
        "tc": 0.0, "f32": 2 * 3 * (8 + 60 + 15 + 10 + 10), "bytes": 2 * (10 + 2 * 3) * 4.0}
    assert roofline.counts("melspec").work({**run_dict, "shape": {**shape,
                                                                  "filterbank": "gammatone"}}) is None


def test_b5_counts_by_hand_and_as_chip_smoke():
    from test_bench_counts import chip_smoke

    shape = {"steps": 4, "neurons": 256, "in_channels": 16, "weight_bytes": 1000,
             "outputs": 64, "width": 256, "out_degree": 26.0, "in_fanout": 8.0}
    run_dict = {"cell_kind": "batch", "utterances": 2, "steps": 1, "shape": shape,
                "rec_rows_per_utt": 10.0, "in_rows_per_utt": 3.0}
    w = roofline.counts("b5").work(run_dict)
    assert w == {"tc": (10 * 26 + 3 * 8) * 2.0, "f32": 2.0 * 2 * 4 * 256,
                 "bytes": 2 * 16 * 4 + 1000 + 2 * (11 * 64 + 256) * 4.0}
    assert w["tc"] + w["f32"] == pytest.approx(
        chip_smoke().sparse_flops(10.0 * 2, 3.0 * 2, 8.0, 26.0, 2, 4, 256))
    assert roofline.counts("b2").work(run_dict) is None
    dense = {**run_dict, "shape": {k: v for k, v in shape.items() if k != "out_degree"}}
    assert roofline.counts("b5").work(dense) is None


def test_the_new_loop_and_reference_load_no_jax_and_the_reference_no_program():
    mods = loaded_top_levels("import benchmark.loops.batch_mel")
    assert not mods & JAX_STACK
    ref = loaded_top_levels("import benchmark.reference.mel")
    assert not ref & (JAX_STACK | {"lsm_tpu_torch"})
