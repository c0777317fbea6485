"""The cell flagship.serve-exact (loops/serve_exact.py over
reference/exact.py) without a card, at a tiny size on the CPU, as
test_bench_faults.py runs the others: a sound program comes out correct
and the control does not; a window shift that drops a sample fails
`window_mismatch`, logits from a perturbed readout fail the logit checks;
the reference loads neither the program nor JAX; a traced run reports
what it can read without a card, counts one `lsm.kws.step` a hop, and
every per-layer reader the cell lists reads a number once the trace holds
device time."""

import json
import math

import pytest
import torch
from test_bench_faults import BENCH, REPO, result, tiny_root  # noqa: F401  (the tiny tree)
from test_bench_imports import JAX_STACK, loaded_top_levels

from benchmark import run
from benchmark.lib import load_module, roofline, spans
from lsm_tpu_torch.models.streaming import StreamingKWS, decode_pcm_device

CELL = "flagship.serve-exact"
CHECKED = {"window_mismatch", "spike_flips", "feature_gap_median", "pred_mismatch",
           "logit_gap_median"}


@pytest.fixture(scope="module")
def exact_root(tiny_root):  # noqa: F811
    """The tiny tree with the exact cell's traffic at 4 streams; warm-up
    still fills every window."""
    ts = json.loads((BENCH / "traffic" / "serve-exact-1024.json").read_text())
    ts.update(pool_parts=1, per_class=1, streams=4, workers=1, check_from=1, check_range=2)
    (tiny_root / "traffic" / "serve-exact-1024.json").write_text(json.dumps(ts))
    return tiny_root


def test_the_cell_runs_the_flagship_on_its_own_traffic():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("flagship", "serve-exact-1024", 1)
    traffic = json.loads((BENCH / "traffic" / "serve-exact-1024.json").read_text())
    assert traffic["loop"] == "serve_exact" and traffic["streams"] == 1024
    assert traffic["warmup_hops"] * traffic["chunk_len"] >= 16000
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())["numbers"]
    assert {k for k, v in limits.items() if v.get("limit") is not None} == CHECKED
    assert limits["window_mismatch"]["limit"] == limits["pred_mismatch"]["limit"] == 0


def test_sound_program_is_correct(exact_root, capsys):
    line = result(capsys, exact_root, CELL)
    assert line["correct"] is True
    assert set(line["checks"]) == CHECKED
    assert line["checks"]["window_mismatch"]["value"] == 0.0
    assert set(line["metrics"]) == {"stream_chunks_per_s", "hop_ms_p95", "setup_s"}


def test_control_is_not_correct(exact_root, capsys):
    assert result(capsys, exact_root, CELL, control=1)["correct"] is False


def _drops_a_sample(self, chunk):
    """The hop's shift with the chunk's first sample dropped (the last
    repeated to keep the window's length)."""
    chunk = decode_pcm_device(chunk)
    n = chunk.shape[-1]
    self.buffer = torch.cat([self.buffer[:, n:], chunk[:, 1:], chunk[:, -1:]], dim=-1)
    return self._evaluate(self.buffer)


def test_a_shift_that_drops_a_sample_fails_window_mismatch(exact_root, capsys, monkeypatch):
    monkeypatch.setattr(StreamingKWS, "_step_device", _drops_a_sample)
    line = result(capsys, exact_root, CELL)
    assert line["correct"] is False
    assert line["checks"]["window_mismatch"]["value"] > 0.0


_evaluate = StreamingKWS._evaluate


@pytest.mark.parametrize("scale,bias", [(1.01, 0.0), (1.0, 0.5)], ids=["weights", "bias"])
def test_a_perturbed_readout_fails_the_logit_checks(exact_root, capsys, monkeypatch, scale, bias):
    def perturbed(self, buffer):
        return _evaluate(self, buffer) * scale + bias * torch.arange(
            self.readout.b.shape[0], dtype=torch.float32)

    monkeypatch.setattr(StreamingKWS, "_evaluate", perturbed)
    line = result(capsys, exact_root, CELL)
    assert line["correct"] is False
    checks = line["checks"]
    assert (checks["pred_mismatch"]["value"] > 0.0
            or checks["logit_gap_median"]["value"] > checks["logit_gap_median"]["limit"])
    assert checks["window_mismatch"]["value"] == 0.0


def test_the_reference_loads_neither_jax_nor_the_program_and_the_loop_no_jax():
    ref = loaded_top_levels("import benchmark.reference.exact")
    assert not ref & (JAX_STACK | {"lsm_tpu_torch"})
    loop = loaded_top_levels("import benchmark.loops.serve_exact as s; s.Port")
    assert not loop & JAX_STACK


def with_device_time(run_dict: dict) -> dict:
    """The run as if its window held device time: every span of the
    reduction 1 ms a hop, the card busy nine tenths of the window."""
    tr, hops = run_dict["trace"], run_dict["hops"]
    red = tr["spans"]
    red["device"] = True
    for v in red["spans"].values():
        v["dev_s"] = v["dev_s_total"] = v["idle_s"] = 1e-3 * hops
    tr["busy_s"] = 0.9 * tr["window_s"]
    return run_dict


def test_a_traced_run_reports_every_metric_its_lists_name(exact_root, capsys, monkeypatch):
    seen = []
    of_run = spans.of_run

    def keep(run_dict):
        seen.append(run_dict)
        return of_run(run_dict)

    monkeypatch.setattr(spans, "of_run", keep)
    line = result(capsys, exact_root, CELL, trace=1)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    listed = [m["name"] for m in run.cell_metrics(bench, CELL, "per_layer")]
    assert {"window_dev_ms.serve", "exact_frontend_dev_ms.serve", "exact_reservoir_dev_ms.serve",
            "mfu.exact.serve", "launches.serve", "engine_host_ms.serve"} <= set(listed)
    # Without a card only the host's numbers read; the card's are None.
    assert set(line["metrics"]) == {"engine_host_ms.serve", "device_idle.serve"}
    assert "breakdown" in line and line["device"]["window_s"] > 0
    run_dict = seen[0]
    red = run_dict["trace"]["spans"]
    assert red["spans"]["lsm.kws.step"]["count"] == run_dict["hops"] > 0
    for stage in ("ingest", "window", "readout", "egress"):
        assert red["spans"][f"lsm.kws.{stage}"]["count"] == run_dict["hops"]
    for stage in ("lsm.frontend", "lsm.reservoir"):
        assert red["spans"][stage]["count"] == run_dict["hops"]
    assert "lsm.kws.frontend" not in red["spans"] and "lsm.kws.reservoir" not in red["spans"]
    assert run_dict["utterances"] == run_dict["hops"] * run_dict["streams"]
    faked = with_device_time(run_dict)
    for name in listed:
        value = load_module(exact_root / "metrics" / f"{name}.py").read(faked)
        assert value is not None and math.isfinite(value), name
    assert roofline.counts("b1").work({**faked, "cell_kind": "batch"})["f32"] == (
        2.0 * 17 * faked["utterances"] * faked["shape"]["channels"] * faked["samples"])


def test_the_new_readers_fall_silent_on_a_program_without_the_exact_spans():
    """The parent's exact engine opens no `lsm.kws.step`: every reader of
    a span is None, and the whole-step share needs only the trace."""
    red = spans.reduce({"spans": [(0.0, 1.0, "lsm.frontend", 1), (1.0, 2.0, "lsm.reservoir", 1)],
                        "calls": [], "device": [(0.0, 2.0, 5)]})
    run_dict = {"cell_kind": "serve", "hops": 1, "trace": {"spans": red, "busy_s": 2.0}}
    for name in ("window_dev_ms.serve", "exact_frontend_dev_ms.serve",
                 "exact_reservoir_dev_ms.serve", "launches.serve", "ingest_dev_ms.serve"):
        assert load_module(BENCH / "metrics" / f"{name}.py").read(run_dict) is None, name
    assert load_module(BENCH / "metrics" / "mfu.exact.serve.py").read(run_dict) is None
