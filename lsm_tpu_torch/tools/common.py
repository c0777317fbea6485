"""What the port's measurement tools share (and `chip_smoke.py` with them):
the card's identity, host walls that end in a synchronize, CUDA-event
times, the serving engines' random-readout modules, the rank set-up of a
multi-process launch and the one JSON line each tool prints last.

Every tool runs on the card unless `--device cpu` is given; then its walls
are the CPU's and the JSON says so (`"device": "cpu"`, no card, CUDA-event
times null).
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Callable, List, Optional

import numpy as np
import torch


def gpu_line() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or
    None where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def identity(device: torch.device) -> dict:
    """The device a tool's numbers come from: its name and, on a card,
    nvidia-smi's name and power limit."""
    if device.type != "cuda":
        return {"device": "cpu", "card": None}
    return {"device": torch.cuda.get_device_name(device), "card": gpu_line()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_walls(fn: Callable, reps: int, device: torch.device, warmup: int = 1,
               before: Optional[Callable] = None) -> List[float]:
    """Seconds of `reps` calls of fn on the host clock, each between two
    synchronize()s (after `warmup` untimed calls); `before` runs ahead of
    each timed call, outside the wall (a barrier across ranks)."""
    for _ in range(warmup):
        fn()
    walls = []
    for _ in range(reps):
        if before is not None:
            before()
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        walls.append(time.perf_counter() - t0)
    return walls


def cuda_ms(fn: Callable, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_ms(fn: Callable, reps: int, device: torch.device) -> Optional[float]:
    """cuda_ms on a card; None (not measured) on the CPU."""
    return cuda_ms(fn, reps) if device.type == "cuda" else None


def serving_modules(n_neurons: int, sparse: bool, n_filters: int, device: torch.device,
                    n_outputs: int = 400, n_classes: int = 12):
    """A reservoir of `n_neurons` with `n_outputs` output neurons (k = 0.2 N;
    mean weight 0.0107 up to 1000 neurons, 0.002 above, as lsm_tpu's
    serving tools draw it), a random readout (N(0, 0.01), seed 0) and an
    identity scaler, on `device`."""
    from lsm_tpu_torch.config import FEATURE_SETS, ReservoirConfig
    from lsm_tpu_torch.models import reservoir as res
    from lsm_tpu_torch.models import sparse as sp
    from lsm_tpu_torch.readout import logistic, scaler

    cfg = ReservoirConfig(num_neurons=n_neurons, num_output_neurons=n_outputs,
                          small_world_k=int(0.10 * n_neurons * 2),
                          mean_weight=0.0107 if n_neurons <= 1000 else 0.002,
                          sparse=True if sparse else None)
    init = sp.init_reservoir_sparse if sparse else res.init_reservoir
    reservoir = init(cfg, n_filters, device=device)
    d = len(FEATURE_SETS["original"]) * reservoir.n_outputs
    rng = np.random.default_rng(0)
    readout = logistic.LogisticReadout(rng.normal(0, 0.01, (d, n_classes)).astype(np.float32),
                                       np.zeros(n_classes, np.float32)).to(device)
    sc = scaler.Scaler(np.zeros(d, np.float32), np.ones(d, np.float32)).to(device)
    return reservoir, readout, sc


def join_ranks() -> bool:
    """Join the process group of a multi-process launch (parallel/mesh.py's
    env contract); True when this process is one of several ranks."""
    import torch.distributed as dist

    from lsm_tpu_torch.parallel.mesh import maybe_init_distributed_from_env

    maybe_init_distributed_from_env()
    return dist.is_initialized()


def emit(rec: dict) -> None:
    """The tool's result: one JSON object on the last line of stdout."""
    print(json.dumps(rec), flush=True)
