"""The whole run without a card, at a tiny size on the CPU: the harness's
look for a chip is skipped and everything else runs as on the card, with
the cells' own limits (limits/<cell>.json). A sound program comes out
correct; the control (the reference in the program's place, each stage
one precision below the configuration's) and each fault a cell can have,
planted in the timed path, come out not correct: an answer altered where
it is produced, half of the batch or of the streams left out, a hop that
leaves its state unchanged."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.loops import port

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A benchmark tree whose cells keep their names, limits, loops,
    metrics and counts, at 16 filters, 256 neurons and a few utterances or
    streams."""
    root = tmp_path_factory.mktemp("bench")
    for d in ("loops", "metrics", "counts", "limits"):
        shutil.copytree(BENCH / d, root / d)
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    for name in ("flagship", "scaled10k"):
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        cfg["frontend"]["n_filters"] = 16
        cfg["reservoir"].update(num_neurons=256, num_output_neurons=64, small_world_k=52)
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    tb = json.loads((BENCH / "traffic" / "batch.json").read_text())
    tb.update(pool_parts=2, per_class=1, utterances_per_step=12, workers=1, max_traced_steps=20)
    (root / "traffic" / "batch.json").write_text(json.dumps(tb))
    for name in ("serve-1024", "serve-4096"):
        ts = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
        ts.update(pool_parts=1, per_class=1, streams=6, workers=1, warmup_hops=2, check_from=2,
                  check_range=2, cycle_hops=30)
        (root / "traffic" / f"{name}.json").write_text(json.dumps(ts))
    return root


def result(capsys, root, cell, control=0, trace=0) -> dict:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 99), "--seconds", "0.3",
                   "--trace", str(trace), "--control", str(control)],
                  bench=bench, root=root, require_cuda=False)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


CELLS = ["flagship.batch", "flagship.serve", "scaled10k.serve"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(tiny_root, capsys, cell):
    line = result(capsys, tiny_root, cell)
    assert line["correct"] is True and line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, capsys, cell):
    assert result(capsys, tiny_root, cell, control=1)["correct"] is False


def _batch_answer_altered(self, audio, events=None):
    out = _batch_step(self, audio, events)
    return {**out, "preds": (out["preds"] + 1) % 12}


def _batch_half_left_out(self, audio, events=None):
    half = audio.shape[0] // 2
    return _batch_step(self, torch.cat([audio[:half], torch.zeros_like(audio[half:])]), events)


def _serve_answer_altered(self, chunk):
    return _serve_step(self, chunk) + 1.0


def _serve_state_unchanged(self, chunk):
    before = self.kws.state
    logits = _serve_step(self, chunk)
    self.kws.state = before
    return logits


def _serve_half_left_out(self, chunk):
    before = self.kws.state
    logits = _serve_step(self, chunk)
    half = self.kws.n_streams // 2
    after = self.kws.state
    for k in ("iir", "hyst", "norm_hi", "norm_lo", "v", "refrac", "s_prev", "win_ring"):
        getattr(after, k)[half:] = getattr(before, k)[half:]
    after.tail[:, half:] = before.tail[:, half:]
    for k, v in after.segs.items():
        v[:, half:] = before.segs[k][:, half:]
    return logits


_batch_step, _serve_step = port.Batch.step, port.Serve.step
FAULTS = [("flagship.batch", "step", _batch_answer_altered),
          ("flagship.batch", "step", _batch_half_left_out),
          ("flagship.serve", "step", _serve_answer_altered),
          ("flagship.serve", "step", _serve_state_unchanged),
          ("flagship.serve", "step", _serve_half_left_out),
          ("scaled10k.serve", "step", _serve_state_unchanged)]


@pytest.mark.parametrize("cell,attr,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(tiny_root, capsys, monkeypatch, cell, attr, fault):
    owner = port.Batch if cell.endswith("batch") else port.Serve
    monkeypatch.setattr(owner, attr, fault)
    assert result(capsys, tiny_root, cell)["correct"] is False


def test_traced_run_reports_the_cells_per_layer_metrics(tiny_root, capsys):
    line = result(capsys, tiny_root, "flagship.batch", trace=1)
    assert {"frontend_ms.batch", "reservoir_ms.batch", "readout_ms.batch"} <= set(line["metrics"])
    assert line["device"]["window_s"] > 0 and "breakdown" in line
