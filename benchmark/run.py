"""Run one cell of BENCHMARK.json once on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds lsm_tpu_torch. The run loads, warms
up, measures for --seconds, checks what the timed path produced against
the plain reference (benchmark/reference), and prints one JSON line last on
stdout: correct, attempted, failed, the cell's end-to-end metrics (--trace
0) or its per-layer metrics (--trace 1), the device, and `checks`, each
compared number beside its limit.

Everything is found by name: the cell's configuration in
configs/<config>.json, its traffic mix in traffic/<traffic>.json, whose
`loop` names the driver in loops/<loop>.py, its limits in
limits/<cell>.json, each per-layer metric's reader in metrics/<metric>.py
and each kernel's counts in counts/<kernel>.py.

--control 1 puts the reference in the program's place, each stage one
precision below the configuration's (benchmark/reference/controls.py):
`correct` must come out false. It is for setting limits, not for the
driver's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lsm_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package lsm_tpu (whole names: lsm_tpu_torch is the program)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Context:
    def __init__(self, args, cell: dict, root: Path, device, started: float):
        from benchmark.lib import trace

        self.cell, self.seed, self.seconds = cell, args.seed, args.seconds
        self.trace, self.control = bool(args.trace), bool(args.control)
        self.config = json.loads((root / "configs" / f"{cell['config']}.json").read_text())
        self.traffic = json.loads((root / "traffic" / f"{cell['traffic']}.json").read_text())
        self.device, self.started = device, started
        self.workers = max(1, min(self.traffic.get("workers", 1), os.cpu_count() or 1))
        self.profile = trace.Profile(self.trace)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch

        self.sync()
        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def reset_peak(self) -> None:
        """Forget the peak memory of warm-up, which holds more than the
        window does."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def device_allocations(self) -> int:
        """cudaMalloc calls of the caching allocator so far (0 on the CPU)."""
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.memory_stats(self.device).get("num_device_alloc", 0))

    def program(self, kind: str, config: dict, weights: dict, **kw):
        """The system under test, or with --control the reference at the
        precision below the configuration's."""
        if self.control:
            from benchmark.reference import controls

            return controls.make(kind, config, weights, self.device, **kw)
        from benchmark.loops import port

        if self.device.type == "cuda":
            port.build_kernels()
        if kind == "batch":
            return port.Batch(config, weights, self.trace)
        return port.Serve(config, weights, **kw, trace=self.trace)


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of `section` that this cell reports."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def main(argv=None, bench: dict | None = None, root: Path = BENCH,
         require_cuda: bool = True) -> int:
    from benchmark.lib import trace

    started = trace.process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if bench is None:
        bench = json.loads(Path("BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    # Any kernel cache the stack might write stays at a fixed path of the
    # checkout (the port itself builds into build/lsm_tpu_torch/).
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root.parent / "build" / sub)
    import torch

    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)

    from benchmark.lib import check, load_module

    ctx = Context(args, cell, root, device, started)
    loop = load_module(root / "loops" / f"{ctx.traffic['loop']}.py")
    res = loop.run(ctx)

    metrics = {}
    if not args.trace:
        values = {**res["e2e"], "setup_s": res["setup_s"]}
        for m in cell_metrics(bench, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell["name"], "per_layer"):
            value = load_module(root / "metrics" / f"{m['name']}.py").read(res["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
           "device": dev}
    if args.trace:
        tr = res["run"]["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}

    found = forbidden_modules()
    if found:
        print(f"the run loaded the JAX stack: {found[:10]}", file=sys.stderr)
        return 3
    correct, checks = check.decide(res["numbers"], check.load_limits(root, cell["name"]))
    line = {"correct": correct, **out, "checks": checks}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(BENCH.parent))
    sys.exit(main())
