"""The four-rank serving loop (loops/serve_mesh.py) without a card: four
gloo ranks on the CPU at a tiny size, with the cell's own limits
(limits/flagship-dp4.serve.json). A sound program comes out correct, with
every rank's gathered logits byte-equal; the control, a rank that writes
its rows one slot off in the gather, and a rank whose copy of the
gathered logits differs from the others' come out not correct; a rank
killed inside the window ends the run non-zero at once, and a program
whose init_distributed takes no timeout fails the run at once. Each run is a
process of its own (rank 0 ends its process when another rank dies), so
the faults are planted in rank 0 by a small driver script."""

import json
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark.lib import corpus, load_module

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
CELL = "flagship-dp4.serve"

DRIVER = textwrap.dedent(
    """
    import json
    import subprocess
    import sys
    from pathlib import Path

    sys.path.insert(0, sys.argv[1])
    import torch

    from benchmark import run
    from benchmark.loops import port
    from lsm_tpu_torch.models import streaming
    from lsm_tpu_torch.parallel import mesh as meshlib

    root, fault, argv = Path(sys.argv[2]), sys.argv[3], sys.argv[4:]
    step = port.Serve.step
    calls = [0]

    if fault == "slot_off":                 # rank 0 writes its rows into rank 1's slot
        def gather_rows(x, mesh, axis=meshlib.DATA_AXIS, dim=0):
            size = mesh.shape[axis]
            raw = x.contiguous().view(torch.uint8).reshape(x.shape[0], -1)
            buf = torch.zeros((size,) + tuple(raw.shape), dtype=torch.uint8, device=x.device)
            buf[(mesh.index(axis) + 1) % size] = raw
            torch.distributed.all_reduce(buf, group=mesh.group(axis))
            return buf.view(x.dtype).reshape((size * x.shape[0],) + tuple(x.shape[1:]))
        streaming.gather_rows = gather_rows
    elif fault == "copy_differs":           # rank 0's copy of the other ranks' rows altered
        def altered(self, chunk):
            out = step(self, chunk).copy()
            out[self.kws.n_local:] += 1.0
            return out
        port.Serve.step = altered
    elif fault == "rank_killed":            # rank 1 killed inside the window
        procs, Popen = [], subprocess.Popen

        class Recorded(Popen):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                procs.append(self)

        subprocess.Popen = Recorded

        def killing(self, chunk):
            calls[0] += 1
            if calls[0] == 6:
                procs[0].kill()
                procs[0].wait()
            return step(self, chunk)
        port.Serve.step = killing
    elif fault == "no_timeout":             # a program whose init_distributed takes none
        plain = meshlib.init_distributed

        def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                             backend=None):
            return plain(coordinator_address, num_processes, process_id, backend)
        meshlib.init_distributed = init_distributed

    bench = json.loads((Path(sys.argv[1]) / "BENCHMARK.json").read_text())
    sys.exit(run.main(argv, bench=bench, root=root, require_cuda=False))
    """
)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """The benchmark tree at 16 filters, 256 neurons and 16 streams, 4 a
    rank, with the cell's names, limits, loops and metrics."""
    root = tmp_path_factory.mktemp("bench_mesh")
    for d in ("loops", "metrics", "counts", "limits"):
        shutil.copytree(BENCH / d, root / d)
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    cfg = json.loads((BENCH / "configs" / "flagship-dp4.json").read_text())
    cfg["frontend"]["n_filters"] = 16
    cfg["reservoir"].update(num_neurons=256, num_output_neurons=64, small_world_k=52)
    (root / "configs" / "flagship-dp4.json").write_text(json.dumps(cfg))
    ts = json.loads((BENCH / "traffic" / "serve-dp4.json").read_text())
    ts.update(pool_parts=1, per_class=1, streams=16, workers=1, warmup_hops=2, check_from=2,
              check_range=2, cycle_hops=30)
    (root / "traffic" / "serve-dp4.json").write_text(json.dumps(ts))
    (root / "driver.py").write_text(DRIVER)
    return root


def run_cell(root, fault="none", control=0, trace=0, timeout=240):
    """(exit code, the result line or None, stderr, seconds)."""
    argv = ["--workload", CELL, "--seed", str(2**31 + 7), "--seconds", "0.3",
            "--trace", str(trace), "--control", str(control)]
    t = time.monotonic()
    p = subprocess.run([sys.executable, str(root / "driver.py"), str(REPO), str(root), fault,
                        *argv], capture_output=True, text=True, timeout=timeout,
                       env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                            "HOME": str(root), "TMPDIR": str(root)})
    lines = p.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, line, p.stderr, time.monotonic() - t


def test_sound_program_is_correct_and_every_rank_holds_the_same_logits(tiny_root):
    rc, line, err, _ = run_cell(tiny_root)
    assert rc == 0, err[-4000:]
    assert line["correct"] is True, err[-4000:]
    assert line["checks"]["gather_mismatch"]["value"] == 0.0
    assert line["attempted"] % 16 == 0 and line["attempted"] >= 16 * 5
    assert set(line["metrics"]) == {"stream_chunks_per_s", "hop_ms_p95", "setup_s"}


def test_traced_run_reports_the_gather_once_a_hop(tiny_root):
    rc, line, err, _ = run_cell(tiny_root, trace=1)
    assert rc == 0, err[-4000:]
    # No card: the device metrics fall silent, but the readers ran (and
    # would have raised on a gather count that is not the hop count).
    assert line["correct"] is True and "busy_s" in line["device"]


@pytest.mark.parametrize("fault", ["control", "slot_off", "copy_differs"])
def test_fault_is_not_correct(tiny_root, fault):
    rc, line, err, _ = run_cell(tiny_root, fault=fault, control=int(fault == "control"))
    assert rc == 0, err[-4000:]
    assert line["correct"] is False
    if fault == "copy_differs":
        assert line["checks"]["gather_mismatch"]["value"] > 0


def test_a_rank_killed_in_the_window_ends_the_run(tiny_root):
    rc, line, err, seconds = run_cell(tiny_root, fault="rank_killed", timeout=150)
    assert rc != 0 and line is None
    assert seconds < 120, err[-4000:]


def test_a_program_without_the_timeout_fails_at_once(tiny_root):
    rc, line, err, seconds = run_cell(tiny_root, fault="no_timeout", timeout=150)
    assert rc != 0 and line is None
    assert "timeout" in err and seconds < 60, err[-4000:]


def test_local_tape_is_the_schedules_rows():
    wire = corpus.to_wire(corpus.synthetic_audio_batch(1, 5, seed=3)[0])
    loop = load_module(BENCH / "loops" / "serve_mesh.py")
    whole = corpus.StreamSchedule(wire, 12, 1600, 30, seed=2**33 + 5)
    for rows in (slice(0, 3), slice(6, 9), slice(9, 12)):
        tape = loop.local_tape(wire, 12, rows, 1600, 30, seed=2**33 + 5)
        for h in (0, 7, 29):
            np.testing.assert_array_equal(tape[h], whole.chunk(h)[rows])


def test_gather_readers_fall_silent_without_the_span():
    run = {"cell_kind": "serve", "hops": 2, "trace": {"spans": {
        "spans": {"lsm.kws.step": {"count": 2, "dev_s": 0.0, "idle_s": 0.0}},
        "device": True}}}
    for name in ("gather_dev_ms.serve", "gather_idle_ms.serve"):
        assert load_module(BENCH / "metrics" / f"{name}.py").read(run) is None
    run["trace"]["spans"]["spans"]["lsm.kws.gather"] = {"count": 2, "dev_s": 0.004,
                                                         "idle_s": 0.002}
    dev = load_module(BENCH / "metrics" / "gather_dev_ms.serve.py").read(run)
    assert dev == pytest.approx(2.0)
    run["trace"]["spans"]["spans"]["lsm.kws.gather"]["count"] = 3
    with pytest.raises(RuntimeError):
        load_module(BENCH / "metrics" / "gather_idle_ms.serve.py").read(run)
