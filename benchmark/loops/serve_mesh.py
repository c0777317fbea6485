"""Closed-loop continuous serving over the ranks of one host: `ranks`
processes, one a card, on a (ranks, 1) data mesh through the program's
own path (lsm_tpu_torch's init_distributed -> make_mesh ->
ContinuousKWS(mesh=) -> step). `streams` streams in all, each rank
feeding its own `streams / ranks` rows of `chunk_len` wire samples a hop;
every hop ends in the program's gather of all the logits onto every rank,
on the host before the next hop's chunk is cut.

Rank 0 is the run.py process. It builds the kernels, starts making the
corpus pool, then starts ranks 1.. as processes of this file
(`python serve_mesh.py <json>`) and serves beside them. Every rank joins
the group through init_distributed with a timeout first (a program whose
init_distributed takes none fails the run at once) and draws the same
weights from the seed (the engine then broadcasts rank 0's, so all serve
the same bits). Rank 0 writes the pool's wire to the run's directory once
it is made; the other ranks load it there. Every rank cuts its own rows of
one schedule of all the streams and warms up as serve.py does. The window's hop count is fixed by rank 0 from its warm-up
hop walls and broadcast once before the window opens, so no collective
but the program's own runs inside it. Rank 0 times every hop, from its
host call to the gathered logits on its host.

Checked on every rank, as serve.py checks (benchmark/lib/check.py): the
rank's own streams at the window's first hop, at a hop drawn from the seed
and at the last, each from the rank's own carried state, reading the
rank's rows of the gathered logits. The other ranks write their readings
and their gathered logits of the checked hops to files; rank 0 takes each
number's worst reading over the ranks, and `gather_mismatch`: the largest
share of gathered logit bytes that differ between a rank and rank 0 at a
checked hop (exact: every rank must hold the same bytes).

No run hangs: the group's timeout (TIMEOUT_S) bounds the rendezvous and
every collective, rank 0 ends the run with exit code 1 as soon as another
rank exits non-zero, and the other ranks end themselves once rank 0 is
gone. Rank 0 prints the program's collectives a hop in the window
(parallel/mesh.py's counters). With --trace 1 every rank records a profiler window over its hops,
so that rank 0's profiler does not make it the slowest; only rank 0's is
reduced. --control 1 puts the reference in the program's place on every
rank, its rows gathered by the harness (torch.distributed.all_gather).
"""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from benchmark.lib import check, corpus, model, trace
from benchmark.loops import port
from benchmark.loops.batch import shape
from benchmark.reference import controls, engines
from lsm_tpu_torch.parallel import mesh as meshlib

TIMEOUT_S = 60           # the group's rendezvous and collectives
JOIN_S = 300             # rank 0's wait for the other ranks' checks
WARMUP_HELD = 8
REPO = Path(corpus.__file__).resolve().parents[2]


class MeshServe(port.Serve):
    """port.Serve's engine on this rank's rows of `mesh`: ContinuousKWS
    with mesh=, whose step returns every stream's logits on every rank."""

    def __init__(self, config: dict, w: dict, streams: int, chunk_len: int, decay: float,
                 mesh, trace: bool = False):
        self.trace = trace
        ro, sc = port.readout(w)
        self.kws = port.ContinuousKWS(port.reservoir(config, w), ro, sc,
                                      port.frontend_config(config), config["feature_set"],
                                      n_streams=streams, chunk_len=chunk_len,
                                      norm_decay_db_per_bin=decay, mesh=mesh)


class ControlMesh:
    """The control on this rank's rows (reference/controls.py), its logits
    gathered onto every rank by the harness."""

    def __init__(self, config: dict, w: dict, device, streams: int, world: int,
                 chunk_len: int, decay: float):
        self.ctl = controls.make("serve", config, w, device, streams=streams // world,
                                 chunk_len=chunk_len, decay=decay)
        self.world = world
        self.at = device if dist.get_backend() == "nccl" else torch.device("cpu")

    def step(self, chunk):
        mine = torch.as_tensor(self.ctl.step(chunk)).to(self.at)
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine)
        return torch.cat(parts).cpu().numpy()

    def state(self) -> dict:
        return self.ctl.state()

    def reset(self) -> None:
        self.ctl.reset()


def join(coordinator: str, world: int, rank: int) -> None:
    """The process group, through the program's init_distributed with a
    timeout."""
    meshlib.init_distributed(coordinator, world, rank,
                             timeout=datetime.timedelta(seconds=TIMEOUT_S))


def wait_for_wire(path: Path) -> np.ndarray:
    """The pool's wire, once rank 0 has written it to `path`."""
    deadline = time.monotonic() + JOIN_S
    while not path.is_file():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no pool from rank 0 in {JOIN_S} s")
        time.sleep(0.05)
    return np.load(path)


def local_tape(wire: np.ndarray, n_streams: int, rows: slice, chunk_len: int,
               cycle_hops: int, seed: int) -> np.ndarray:
    """(cycle_hops, rows, chunk_len): `rows` of corpus.StreamSchedule's
    tape of all n_streams streams, without the whole tape. The schedule is
    drawn over chunk indices (a one-sample 'chunk' per index), so the draw
    is StreamSchedule's own."""
    n_utt, n_samples = wire.shape
    per_utt = n_samples // chunk_len
    index = np.arange(n_utt * per_utt).reshape(n_utt, per_utt)
    picked = corpus.StreamSchedule(index, n_streams, 1, cycle_hops, seed).tape[:, rows, 0]
    return wire[:, :per_utt * chunk_len].reshape(n_utt * per_utt, chunk_len)[picked]


def byte_mismatch(a: np.ndarray, b: np.ndarray) -> float:
    """Share of the bytes of a that differ from b's (1 where the shapes
    differ)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return 1.0
    return float(np.mean(a.view(np.uint8) != b.view(np.uint8)))


def serve(r: SimpleNamespace) -> dict:
    """One rank's run: set-up, warm-up, the window and the check of its own
    streams. `r` holds rank, world, config, traffic, seed, seconds, device,
    started, trace, control, coordinator, profile and wire (a callable that
    returns the pool's wire)."""
    cfg, tr, dev = r.config, r.traffic, r.device
    n, chunk_len, decay = tr["streams"], tr["chunk_len"], tr["norm_decay_db_per_bin"]
    n_local = n // r.world
    rows = slice(r.rank * n_local, (r.rank + 1) * n_local)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    join(r.coordinator, r.world, r.rank)
    weights = model.make(cfg, r.seed, dev)
    sync()
    if r.control:
        prog = ControlMesh(cfg, weights, dev, n, r.world, chunk_len, decay)
    else:
        mesh = meshlib.make_mesh(r.world, 1, device=dev)
        prog = MeshServe(cfg, weights, n, chunk_len, decay, mesh, r.trace)
        if prog.kws.rows != rows:
            raise RuntimeError(f"rank {r.rank} serves {prog.kws.rows}, expected {rows}")
    wire = r.wire()
    if r.rank == 0:
        print(f"set-up: {r.world} ranks joined, program and pool at "
              f"{time.time() - r.started:.2f} s of the process", file=sys.stderr)
    tape = local_tape(wire, n, rows, chunk_len, tr["cycle_hops"], r.seed)
    del wire
    chunk = lambda h: tape[h % tr["cycle_hops"]]        # noqa: E731
    rng = np.random.default_rng(corpus.part_seed(r.seed, 1 << 22))
    k_check = int(rng.integers(tr["check_from"], tr["check_from"] + tr["check_range"]))

    # Warm-up as serve.py's: every shape, more states alive than the window keeps.
    held, warm = [], []
    for h in range(tr["warmup_hops"]):
        t = time.perf_counter()
        prog.step(chunk(h))
        warm.append(time.perf_counter() - t)
        held = (held + [prog.state()])[-WARMUP_HELD:]
    del held
    prog.reset()
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # The window's hops: rank 0's, from the fastest hop of its warm-up's
    # later half (warm-up hops also fill the allocator), so that the window
    # lasts about --seconds.
    hops = max(tr["check_from"] + tr["check_range"] + 1,
               math.ceil(r.seconds / min(warm[len(warm) // 2:])))
    count = torch.tensor([hops], dtype=torch.int64,
                         device=dev if dist.get_backend() == "nccl" else "cpu")
    dist.broadcast(count, src=0)
    hops = int(count.item())
    if r.rank == 0:
        print(f"warm-up hop walls {[round(t * 1e3, 2) for t in warm]} ms: {hops} hops in the "
              f"window", file=sys.stderr)

    setup_s = time.time() - r.started
    walls, kept = [], {}
    issued = (meshlib.collectives, meshlib.collective_bytes)
    with r.profile as prof:
        t0 = time.perf_counter()
        for h in range(hops):
            with trace.span("harness: cut the hop's chunk", r.trace):
                x = chunk(h)
            before = prog.state()
            t = time.perf_counter()
            logits = prog.step(x)
            walls.append(time.perf_counter() - t)
            if h in (0, k_check, hops - 1):
                kept[h] = (before, prog.state(), logits)
        window_s = time.perf_counter() - t0
    issued = (meshlib.collectives - issued[0], meshlib.collective_bytes - issued[1])
    sync()
    memory = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    del before, logits

    ref = engines.Stream(cfg, weights, dev, chunk_len, decay)
    readings, rec_rows, in_rows = [], 0.0, 0.0
    for hop, (before, after, logits) in sorted(kept.items()):
        start = ref.init_state(n_local) if hop == 0 else before
        ref_after, ref_logits, rec, inp = ref.hop(start, torch.as_tensor(chunk(hop)).to(dev))
        readings.append(check.hop_numbers(after, logits[rows], ref_after, ref_logits,
                                          cfg["reservoir"]["membrane_threshold"]))
        rec_rows, in_rows = rec_rows + rec, in_rows + inp
        del ref_after, ref_logits
    out = {"hops": hops, "walls": walls, "window_s": window_s, "setup_s": setup_s,
           "memory": memory, "numbers": check.worst(readings), "issued": issued,
           "gathered": {h: v[2] for h, v in kept.items()}}
    if r.trace and r.rank == 0:
        f = cfg["frontend"]
        st = ref.init_state(1)
        state_bytes = sum(t.numel() * t.element_size() for k, t in st.items() if k != "segs")
        state_bytes += sum(t.numel() * t.element_size() for t in st["segs"].values())
        out["run"] = {
            "trace": prof.reduce(window_s), "cell_kind": "serve", "hops": hops,
            "streams": n_local, "hop_walls_s": float(np.sum(walls)), "chunk_len": chunk_len,
            "t_c": ref.t_c, "n_new_win": ref.n_new_win, "n_sub": chunk_len // ref.frontend.g,
            "shape": {**shape(cfg, weights), "state_bytes_per_stream": state_bytes},
            "rec_rows_per_stream_hop": rec_rows / (n_local * len(kept)),
            "in_rows_per_stream_hop": in_rows / (n_local * len(kept)),
            "channels": f["n_filters"],
        }
    del kept, prog
    dist.destroy_process_group()
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def guard_workers(procs: list, done: threading.Event) -> None:
    """Rank 0's watch: a rank that exits non-zero ends the run at once
    (the others would wait in the next collective)."""
    while not done.wait(0.2):
        for rank, p in enumerate(procs, 1):
            if p.poll() not in (None, 0) and not done.is_set():
                print(f"rank {rank} exited with {p.returncode}: the run ends",
                      file=sys.stderr, flush=True)
                os._exit(1)


def guard_parent(parent: int) -> None:
    """A worker's watch: rank 0 gone (this process re-parented), it ends."""
    while os.getppid() == parent:
        time.sleep(0.2)
    os._exit(1)


def run(ctx) -> dict:
    """Rank 0 (run.py's process) and the run's result."""
    tr = ctx.traffic
    world = tr["ranks"]
    if ctx.device.type == "cuda" and not ctx.control:
        port.build_kernels()           # built once, before the other ranks load it
    spec = {"config": ctx.config, "traffic": tr, "seed": ctx.seed, "seconds": ctx.seconds,
            "trace": ctx.trace, "control": ctx.control, "cuda": ctx.device.type == "cuda",
            "coordinator": f"localhost:{free_port()}"}
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                                         if p)}
    done = threading.Event()
    with tempfile.TemporaryDirectory(prefix="serve_mesh_") as tmp, \
            contextlib.ExitStack() as making:
        # The pool is made once, here, while the ranks start and join.
        pool = making.enter_context(corpus.Pool(
            tr["corpus"], tr["pool_parts"], tr["per_class"], ctx.config["classes"], ctx.seed,
            max(1, min(tr["workers"], os.cpu_count() or 1))))

        def publish() -> np.ndarray:
            wire = corpus.to_wire(pool.result())
            making.close()                        # the pool's processes end
            part = Path(tmp) / "wire.part"
            with open(part, "wb") as f:
                np.save(f, wire)
            os.replace(part, Path(tmp) / "wire.npy")
            return wire

        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   json.dumps({**spec, "rank": k, "out": tmp})],
                                  env=env, stdout=2)
                 for k in range(1, world)]
        watch = threading.Thread(target=guard_workers, args=(procs, done), daemon=True)
        watch.start()
        try:
            mine = serve(SimpleNamespace(**spec, rank=0, world=world, device=ctx.device,
                                         started=ctx.started, profile=ctx.profile,
                                         wire=publish))
            for p in procs:
                p.wait(timeout=JOIN_S)
        finally:
            done.set()
            for p in procs:
                if p.poll() is None:
                    p.kill()
        bad = [(k, p.returncode) for k, p in enumerate(procs, 1) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks exited non-zero: {bad}")
        theirs = [json.loads((Path(tmp) / f"rank{k}.json").read_text()) for k in range(1, world)]
        mismatch = 0.0
        for k in range(1, world):
            for h, logits in mine["gathered"].items():
                path = Path(tmp) / f"rank{k}.hop{h}.npy"
                other = np.load(path) if path.is_file() else np.empty(0)
                mismatch = max(mismatch, byte_mismatch(other, logits))
    if any(t["hops"] != mine["hops"] for t in theirs):
        raise RuntimeError(f"ranks ran {[t['hops'] for t in theirs]} hops, rank 0 {mine['hops']}")
    hops, n = mine["hops"], tr["streams"]
    walls_ms = np.asarray(mine["walls"]) * 1e3
    p95 = float(np.percentile(walls_ms, 95))
    print(f"ranks {world}, hops {hops}, hop wall median {float(np.median(walls_ms))!r} ms, "
          f"p95 {p95!r} ms, window {mine['window_s']!r} s; other ranks' windows "
          f"{[t['window_s'] for t in theirs]!r} s; the program's collectives a hop "
          f"{mine['issued'][0] / hops!r}, {mine['issued'][1] / hops!r} bytes", flush=True)
    numbers = check.worst([mine["numbers"]] + [t["numbers"] for t in theirs])
    result = {"attempted": hops * n, "failed": 0, "setup_s": mine["setup_s"],
              "memory_peak_bytes": mine["memory"],
              "e2e": {"stream_chunks_per_s": hops * n / mine["window_s"], "hop_ms_p95": p95},
              "numbers": {**numbers, "gather_mismatch": mismatch}}
    if "run" in mine:
        result["run"] = mine["run"]
    return result


def worker(spec: dict) -> int:
    """Ranks 1..: serve beside rank 0, then leave the readings and the
    gathered logits of the checked hops in spec["out"]."""
    threading.Thread(target=guard_parent, args=(os.getppid(),), daemon=True).start()
    started = trace.process_start()
    rank = spec["rank"]
    if spec["cuda"]:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    d = Path(spec["out"])
    out = serve(SimpleNamespace(**{k: v for k, v in spec.items() if k != "out"},
                                world=spec["traffic"]["ranks"], device=device, started=started,
                                profile=trace.Profile(spec["trace"]),
                                wire=lambda: wait_for_wire(d / "wire.npy")))
    from benchmark import run as runner

    found = runner.forbidden_modules()
    if found:
        print(f"rank {rank} loaded the JAX stack: {found[:10]}", file=sys.stderr)
        return 3
    for h, logits in out["gathered"].items():
        np.save(d / f"rank{rank}.hop{h}.npy", logits)
    (d / f"rank{rank}.json").write_text(json.dumps(
        {k: out[k] for k in ("hops", "window_s", "numbers")}))
    return 0


if __name__ == "__main__":
    sys.exit(worker(json.loads(sys.argv[1])))
