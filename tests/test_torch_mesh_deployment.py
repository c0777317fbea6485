"""The flagship's data-parallel serving deployment through the port's mesh
path (parallel/mesh.py, models/streaming.py, models/continuous.py), as
the four-card benchmark cell serves it, at a tiny size: four ranks joined
through the LSM_TPU_COORDINATOR env contract (as
tests/test_torch_serving_mesh.py does), a (4, 1) data mesh, ContinuousKWS
with mesh=, 16 streams (4 a rank), 16 filters, a 128-neuron dense
reservoir, 12 classes, 100 ms hops, 6 hops of seeded hard-corpus audio.
On the CPU the ranks are gloo processes with one torch thread each; on
four cards (marked gpu) they are NCCL processes, one a card.

Against the benchmark's plain reference (benchmark/reference/engines.py
`Stream`, run in this process over all 16 streams in blocks of 4 rows, a
rank's share), on the benchmark's own seeded weights (benchmark/lib/
model.py), on the CPU: the gathered logits of every hop and every rank's
carried state after every hop bit-equal. The tolerance is
benchmark/tests/test_bench_reference.py's, and for its reason: on the CPU
the port's plain path and the reference do the same float32 operations in
the same order on blocks of the same shape, so any difference is a fault,
not a rounding. The gathered logits are byte-equal on all four ranks (an
exact gather). Each hop issues exactly one collective, of the gather's
whole buffer: 4 slots of 4 streams x 12 classes x 4 B. Under a torch
profiler each hop opens one `lsm.kws.gather` inside `lsm.kws.egress`; an
engine without a mesh opens none.

Beside it, init_distributed's timeout: a rank whose peer left, or stalls
before a collective, raises within the timeout instead of blocking; and
without one, torch's default is left alone.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.lib import corpus, model  # noqa: E402
from benchmark.loops import port  # noqa: E402
from benchmark.reference import engines  # noqa: E402
from lsm_tpu_torch.models.continuous import ContinuousKWS  # noqa: E402
from lsm_tpu_torch.parallel import mesh as ml  # noqa: E402

torch.set_num_threads(1)

WORLD, N, L, HOPS, K = 4, 16, 1600, 6, 12
SEED = 2**32 + 18
LEAVES = ("iir", "tail", "hyst", "norm_hi", "norm_lo", "v", "refrac", "s_prev", "win_ring")

WORKER = textwrap.dedent(
    """
    import json
    import sys
    from pathlib import Path

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from lsm_tpu_torch.parallel import mesh as ml

    assert ml.maybe_init_distributed_from_env(), "env contract not honored"
    import torch.distributed as dist

    from benchmark.lib import model
    from benchmark.loops import port
    from lsm_tpu_torch.models.continuous import ContinuousKWS

    out_dir, cuda = Path(sys.argv[1]), sys.argv[2] == "cuda"
    cfg = json.loads((out_dir / "config.json").read_text())
    tape = np.load(out_dir / "tape.npy")
    rank = dist.get_rank()
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    mesh = ml.make_mesh(4, 1, device=dev)
    w = model.make(cfg, int(sys.argv[3]), dev)
    ro, sc = port.readout(w)
    kws = ContinuousKWS(port.reservoir(cfg, w), ro, sc, port.frontend_config(cfg),
                        cfg["feature_set"], n_streams=tape.shape[1], chunk_len=tape.shape[2],
                        norm_decay_db_per_bin=0.1, mesh=mesh)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {"backend": np.asarray(dist.get_backend()), "device": np.asarray(str(kws.device)),
           "rows": np.asarray([kws.rows.start, kws.rows.stop])}
    with torch.profiler.profile(activities=acts) as prof:
        for h in range(tape.shape[0]):
            c0, b0 = ml.collectives, ml.collective_bytes
            out[f"logits{h}"] = kws.step(tape[h][kws.rows])
            out[f"collectives{h}"] = np.asarray([ml.collectives - c0, ml.collective_bytes - b0])
            st = kws.state
            for k in %s:
                out[f"state{h}:{k}"] = getattr(st, k).cpu().numpy()
            for k, v in st.segs.items():
                out[f"state{h}:segs:{k}"] = v.cpu().numpy()
    gathers = [e for e in prof.events() if e.name == "lsm.kws.gather"
               and e.device_type == torch.autograd.DeviceType.CPU]   # not the card's shadow
    out["gathers"] = np.asarray(len(gathers))
    out["gathers_in_egress"] = np.asarray(sum(
        e.cpu_parent is not None and e.cpu_parent.name == "lsm.kws.egress" for e in gathers))
    np.savez(out_dir / f"rank{rank}.npz", **out)
    ml.barrier(mesh)
    """ % (LEAVES,)
)

TIMEOUT_WORKER = textwrap.dedent(
    """
    import datetime
    import os
    import sys
    import time

    import torch
    import torch.distributed as dist

    from lsm_tpu_torch.parallel import mesh as ml

    mode, rank, coord = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    ml.init_distributed(coord, 2, rank, backend="gloo",
                        timeout=datetime.timedelta(seconds=float(sys.argv[4])))
    if rank == 1:
        if mode == "exits":
            os._exit(0)
        time.sleep(60)                     # stalls before the collective
        os._exit(0)
    time.sleep(0.5)
    t = time.monotonic()
    try:
        dist.all_reduce(torch.ones(4))
    except RuntimeError as e:
        print(f"raised after {time.monotonic() - t:.2f} s: {str(e)[:200]}", flush=True)
        os._exit(0)
    print("the collective returned", flush=True)
    os._exit(1)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tiny_config() -> dict:
    cfg = json.loads((REPO / "benchmark" / "configs" / "flagship-dp4.json").read_text())
    cfg["frontend"]["n_filters"] = 16
    cfg["reservoir"].update(num_neurons=128, num_output_neurons=64, small_world_k=16)
    assert cfg["classes"] == K
    return cfg


def spawn_ranks(d: Path, cuda: bool) -> list:
    """Every rank's results of WORKER on the (4, 1) mesh."""
    cfg = tiny_config()
    wire = corpus.to_wire(corpus.synthetic_audio_batch_hard(1, cfg["classes"], seed=9)[0])
    sched = corpus.StreamSchedule(wire, N, L, 30, seed=SEED)
    (d / "config.json").write_text(json.dumps(cfg))
    np.save(d / "tape.npy", np.stack([sched.chunk(h) for h in range(HOPS)]))
    (d / "worker.py").write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
           "LSM_TPU_COORDINATOR": f"localhost:{_free_port()}",
           "LSM_TPU_NUM_PROCESSES": str(WORLD), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(d / "worker.py"), str(d),
                               "cuda" if cuda else "cpu", str(SEED)],
                              env={**env, "LSM_TPU_PROCESS_ID": str(i)}, cwd=d,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i} failed:\n{logs[i][-4000:]}"
    return [dict(np.load(d / f"rank{i}.npz")) for i in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("mesh_deployment"), cuda=False)


@pytest.fixture(scope="module")
def reference():
    """The reference's logits and state after every hop, all 16 streams."""
    cfg = tiny_config()
    w = model.make(cfg, SEED, "cpu")
    ref = engines.Stream(cfg, w, torch.device("cpu"), L, 0.1, rows=N // WORLD)
    wire = corpus.to_wire(corpus.synthetic_audio_batch_hard(1, cfg["classes"], seed=9)[0])
    sched = corpus.StreamSchedule(wire, N, L, 30, seed=SEED)
    st, out = ref.init_state(N), []
    for h in range(HOPS):
        st, logits, _, _ = ref.hop(st, torch.as_tensor(sched.chunk(h)))
        out.append((st, logits.numpy()))
    return out


def test_every_rank_serves_its_rows_on_gloo(ranks):
    for i, r in enumerate(ranks):
        assert str(r["backend"]) == "gloo" and str(r["device"]) == "cpu"
        assert list(r["rows"]) == [i * N // WORLD, (i + 1) * N // WORLD]


@pytest.mark.parametrize("hop", range(HOPS))
def test_gathered_logits_equal_the_reference(ranks, reference, hop):
    for r in ranks:
        assert r[f"logits{hop}"].shape == (N, K)
        np.testing.assert_array_equal(r[f"logits{hop}"], reference[hop][1])


@pytest.mark.parametrize("hop", range(HOPS))
def test_every_ranks_state_equals_the_reference(ranks, reference, hop):
    st = reference[hop][0]
    for i, r in enumerate(ranks):
        rows = slice(*r["rows"])
        for k in LEAVES:
            want = st[k][:, rows] if k == "tail" else st[k][rows]
            np.testing.assert_array_equal(r[f"state{hop}:{k}"], want.numpy(), err_msg=(i, k))
        for k, v in st["segs"].items():
            np.testing.assert_array_equal(r[f"state{hop}:segs:{k}"], v[:, rows].numpy(),
                                          err_msg=(i, k))


def test_gathered_logits_are_byte_equal_on_every_rank(ranks):
    for h in range(HOPS):
        first = ranks[0][f"logits{h}"]
        for r in ranks[1:]:
            assert r[f"logits{h}"].tobytes() == first.tobytes()


def test_one_collective_of_the_whole_buffer_a_hop(ranks):
    for r in ranks:
        for h in range(HOPS):
            assert list(r[f"collectives{h}"]) == [1, WORLD * (N // WORLD) * K * 4]


def test_one_gather_span_a_hop_inside_egress(ranks):
    for r in ranks:
        assert int(r["gathers"]) == HOPS
        assert int(r["gathers_in_egress"]) == HOPS


def test_an_engine_without_a_mesh_opens_no_gather_span():
    cfg = tiny_config()
    w = model.make(cfg, SEED, "cpu")
    ro, sc = port.readout(w)
    kws = ContinuousKWS(port.reservoir(cfg, w), ro, sc, port.frontend_config(cfg),
                        cfg["feature_set"], n_streams=2, chunk_len=L)
    chunk = np.zeros((2, L), np.int16)
    c0 = ml.collectives
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        kws.step(chunk)
    names = {e.name for e in prof.events()}
    assert "lsm.kws.egress" in names and "lsm.kws.gather" not in names
    assert ml.collectives == c0


@pytest.mark.gpu
def test_four_nccl_ranks_one_card_each(tmp_path):
    """On four cards: NCCL ranks, one a card, with the kernels; the
    gathered logits byte-equal on every rank, one collective of the whole
    buffer and one gather span a hop."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices")
    got = spawn_ranks(tmp_path, cuda=True)
    for i, r in enumerate(got):
        assert str(r["backend"]) == "nccl" and str(r["device"]) == f"cuda:{i}"
        for h in range(HOPS):
            assert r[f"logits{h}"].tobytes() == got[0][f"logits{h}"].tobytes()
            assert np.isfinite(r[f"logits{h}"]).all()
            assert list(r[f"collectives{h}"]) == [1, WORLD * (N // WORLD) * K * 4]
        assert int(r["gathers"]) == HOPS and int(r["gathers_in_egress"]) == HOPS


@pytest.mark.parametrize("mode", ["exits", "stalls"])
def test_a_rank_raises_within_the_timeout_when_its_peer_is_gone(tmp_path, mode):
    (tmp_path / "w.py").write_text(TIMEOUT_WORKER)
    coord, timeout = f"localhost:{_free_port()}", 3.0
    env = {**os.environ, "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "w.py"), mode, str(i), coord,
                               str(timeout)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    t = time.monotonic()
    try:
        log = procs[0].communicate(timeout=60)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[0].returncode == 0, log[-3000:]
    assert "raised after" in log
    assert time.monotonic() - t < 45


def test_init_distributed_keeps_torchs_default_timeout(monkeypatch):
    seen = []
    monkeypatch.setattr(ml.dist, "init_process_group", lambda *a, **k: seen.append(k))
    ml.init_distributed("localhost:1", 1, 0, backend="gloo")
    td = datetime.timedelta(seconds=7)
    ml.init_distributed("localhost:1", 1, 0, backend="gloo", timeout=td)
    assert "timeout" not in seen[0]
    assert seen[1]["timeout"] == td
    assert {k: v for k, v in seen[1].items() if k != "timeout"} == seen[0]
