"""The port's measurement tools (lsm_tpu_torch/tools/{bench_streaming,
bench_continuous, bench_state, bench_tp, profile_stages}.py) at a tiny
size on the CPU: each exits cleanly and its last stdout line is the JSON
object its docstring names, with the fields filled. bench_tp runs as two
gloo ranks (and as one process, a one-rank group), the others in this
process. No time here is a device number: the JSON says "device": "cpu".
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lsm_tpu_torch.tools import (
    bench_continuous, bench_state, bench_streaming, profile_stages,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--n-filters", "16", "--num-neurons", "128", "--num-outputs", "64"]


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _run(main, argv, capsys) -> dict:
    rec = main(argv)
    printed = _last_json(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(rec))
    assert printed["device"] == "cpu" and printed["card"] is None
    return printed


@pytest.mark.parametrize("extra", [[], ["--compact", "--ulaw"], ["--pipelined"],
                                   ["--continuous", "--pcm16", "--active-frac", "0.5"]],
                         ids=["exact", "compact", "pipelined", "continuous_active"])
def test_bench_streaming(capsys, extra):
    rec = _run(bench_streaming.main, SMALL + ["--streams", "2", "4", "--steps", "2"] + extra,
               capsys)
    assert rec["tool"] == "bench_streaming" and rec["ranks"] == 1 and rec["budget_ms"] == 100.0
    assert rec["engine"] == ("continuous" if "--continuous" in extra else "exact")
    assert [r["streams"] for r in rec["rows"]] == [2, 4]
    for r in rec["rows"]:
        assert r["hop_ms_min"] <= r["hop_ms_median"]
        assert r["stream_chunks_per_s"] == r["stream_chunks_per_s_per_rank"] > 0
        assert r["real_time_factor"] > 0 and isinstance(r["within_budget"], bool)


def test_bench_state(capsys):
    rec = _run(bench_state.main, SMALL + ["--streams", "4", "--migrate-k", "2", "--reps", "2"],
               capsys)
    for k in ("step_ms", "snapshot_ms", "save_ms", "save_raw_ms", "load_ms", "migrate_ms",
              "extract_ms", "state_mb", "file_mb_raw"):
        assert rec[k] > 0, k
    assert rec["continues_bit_equal"] is True
    assert rec["streams"] == 4 and rec["migrate_k"] == 2


def test_bench_continuous(capsys):
    rec = _run(bench_continuous.main,
               SMALL + ["--n-per-class", "5", "--bench-streams", "2", "--steps", "2"], capsys)
    assert rec["n_test"] == 12 and 0.0 <= rec["exact_accuracy"] <= 1.0
    for k in ("cold", "carry_in"):
        assert 0.0 <= rec[k]["accuracy"] <= 1.0 and 0.0 <= rec[k]["agreement"] <= 1.0
    assert 0.0 <= rec["matched_accuracy"] <= 1.0
    (row,) = rec["bench"]
    assert row["streams"] == 2
    assert row["work_ratio"] == row["exact_hop_ms_median"] / row["continuous_hop_ms_median"]


def test_bench_continuous_sweep(capsys):
    """A 50 ms chunk spans half a rate window: that grid point is null."""
    rec = _run(bench_continuous.main,
               SMALL + ["--n-per-class", "5", "--sweep", "--sweep-decays", "0.1",
                        "--sweep-chunks", "100", "50"], capsys)
    assert [(r["decay"], r["chunk_ms"]) for r in rec["sweep"]] == [(0.1, 100), (0.1, 50)]
    assert 0.0 <= rec["sweep"][0]["matched_accuracy"] <= 1.0
    assert rec["sweep"][1]["matched_accuracy"] is None


@pytest.mark.parametrize("continuous", [False, True], ids=["batch", "continuous"])
def test_profile_stages(capsys, continuous):
    rec = _run(profile_stages.main, SMALL + ["--n", "4", "--repeats", "1"]
               + (["--continuous"] if continuous else []), capsys)
    assert [s["name"] for s in rec["stages"]] == [
        "featurize", "reservoir+features", "standardize+predict"]
    assert all(s["ms_min"] > 0 and s["event_ms"] is None and s["utt_per_s"] > 0
               for s in rec["stages"])
    if continuous:
        assert [s["name"] for s in rec["continuous_stages"]] == [
            "gtgram chunk", "LIF chunk", "fold+features+predict"]
        assert rec["streams"] == 4
    else:
        assert "continuous_stages" not in rec


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _bench_tp(tmp_path, ranks, extra):
    argv = [sys.executable, "-m", "lsm_tpu_torch.tools.bench_tp", "--device", "cpu",
            "--num-neurons", "256", "--num-outputs", "64", "--n-channels", "16", "--batch", "4",
            "--t", "20", "--repeats", "1"] + extra
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    if ranks > 1:
        env.update(LSM_TPU_COORDINATOR=f"localhost:{_free_port()}",
                   LSM_TPU_NUM_PROCESSES=str(ranks))
    procs = [subprocess.Popen(argv, cwd=tmp_path, env={**env, "LSM_TPU_PROCESS_ID": str(i)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(ranks)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i}:\n{out[-2000:]}\n{err[-3000:]}"
    assert all(not out.strip() for out, _ in outs[1:])      # rank 0 alone prints
    return _last_json(outs[0][0])


@pytest.mark.parametrize("ranks,extra", [(2, ["--sparse"]), (2, []), (1, [])],
                         ids=["two_ranks_sparse", "two_ranks_dense", "one_rank"])
def test_bench_tp(tmp_path, ranks, extra):
    rec = _bench_tp(tmp_path, ranks, extra)
    assert rec["tool"] == "bench_tp" and rec["ranks"] == ranks and rec["device"] == "cpu"
    assert rec["mesh"] == {"data": 1, "model": ranks}
    assert rec["sparse"] == ("--sparse" in extra) and rec["neurons"] == 256
    for k in ("tp_s_min", "tp_utt_per_s", "tp_utt_per_s_per_rank", "single_s_min",
              "single_utt_per_s"):
        assert rec[k] > 0, k
    assert rec["checksum"] != 0.0
