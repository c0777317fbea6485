"""The port's stage entry points write lsm_tpu's --metrics-out records:
for the same argv (with --single-device, which both take), each entry
point of both packages runs on the CPU at a tiny size and their JSONL
files hold the same metric names in the same order with the same tag
names, and equal values for every tag that does not time anything.
lsm_tpu's entry points are the repo-root scripts, loaded by path; the
names of main.py's records are the ones chip_smoke.py phase 15 requires."""

import importlib.util
import json
from pathlib import Path

import torch

from lsm_tpu_torch import __main__ as tcli
from lsm_tpu_torch.cli import create_dataset, extract_lsm_features, train_classifier

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# Tags measured by the run: named alike, valued apart (a wall or a rate;
# L-BFGS iteration counts differ between the two optimizers; participation
# is held within 1 point below).
VARIES = {"ts", "value", "utt_per_sec", "wall_s", "lbfgs_iters", "avg_participation"}
VOCAB = ["--commands", "a,b,c,d"]
SYN = ["--synthetic", "--samples-per-class", "6", "--n-filters", "16", "--batch-size", "64"]
RES = ["--num-neurons", "128", "--num-output-neurons", "64"]
FLAGS = ["--single-device", "--metrics-out", "m.jsonl"]


def _reference(script: str):
    spec = importlib.util.spec_from_file_location(f"_reference_{script}", REPO / f"{script}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _assert_same_records(port: list, ref: list) -> None:
    assert [r["metric"] for r in port] == [r["metric"] for r in ref]
    for p, r in zip(port, ref):
        assert list(p) == list(r), p["metric"]
        assert {k: v for k, v in p.items() if k not in VARIES} == \
            {k: v for k, v in r.items() if k not in VARIES}, p["metric"]
        assert type(p["value"]) is type(r["value"]), p["metric"]
        if "avg_participation" in p:
            assert abs(p["avg_participation"] - r["avg_participation"]) <= 1.0


def _run_both(tmp_path, monkeypatch, steps):
    """steps: [(port main, repo-root script, argv)], run in order in one
    directory per package; returns (port records, reference records)."""
    monkeypatch.setenv("LSM_TPU_NO_CACHE", "1")
    out = {}
    for side in ("port", "lsm_tpu"):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        for port_main, script, argv in steps:
            if side == "port":
                port_main(argv + ["--device", "cpu"])
            else:
                monkeypatch.setattr("sys.argv", [f"{script}.py", *argv])
                _reference(script).main()
        out[side] = _records(d / "m.jsonl")
    return out["port"], out["lsm_tpu"]


def _chip_smoke_main_metrics() -> list:
    """The names chip_smoke.py phase 15 requires of the configs[2] run."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return list(mod.MAIN_PY_METRICS)


MAIN_METRICS = _chip_smoke_main_metrics()


def test_main_records_equal_reference(tmp_path, monkeypatch):
    port, ref = _run_both(tmp_path, monkeypatch, [
        (tcli.main, "main", SYN + VOCAB + RES + FLAGS + ["--skip-artifacts"])])
    assert [r["metric"] for r in port] == MAIN_METRICS
    _assert_same_records(port, ref)
    assert port[0]["utterances"] == 24


def test_stage_entry_points_records_equal_reference(tmp_path, monkeypatch):
    """create_dataset -> extract_lsm_features -> train_classifier, each
    appending to one metrics file."""
    port, ref = _run_both(tmp_path, monkeypatch, [
        (create_dataset.main, "create_dataset", SYN + VOCAB + FLAGS),
        (extract_lsm_features.main, "extract_lsm_features", VOCAB + RES + FLAGS),
        (train_classifier.main, "train_classifier", VOCAB + FLAGS),
    ])
    assert [r["metric"] for r in port] == MAIN_METRICS
    assert port[0]["filterbank"] == "gammatone"
    _assert_same_records(port, ref)


def test_streaming_fit_records_equal_reference(tmp_path, monkeypatch):
    port, ref = _run_both(tmp_path, monkeypatch, [
        (create_dataset.main, "create_dataset", SYN + VOCAB + ["--sharded-output", "sh"]),
        (extract_lsm_features.main, "extract_lsm_features",
         ["--input", "sh", "--streaming-fit", "--readout", "ridge", "--ridge-alpha", "2",
          "--batch-size", "16"] + RES + FLAGS),
    ])
    assert [r["metric"] for r in port] == ["streaming_fit_wall_s", "w_critico",
                                           "test_accuracy"]
    assert port[2]["readout"] == "ridge" and port[2]["ridge_alpha"] == 2.0
    _assert_same_records(port, ref)
