#!/usr/bin/env python3
"""Split a step of the block body (csrc/sparse_lif.cu, B5/B6) among its
weight loads, products and state traffic on one GPU (ROADMAP E11: there is
no ncu on the card's machine).

Run from the repository root:  python3 tools/block_split.py [--out F]
    [--variant NAME=DEF[,DEF...]] ...

Builds csrc/sparse_lif.cu once per variant with nvcc (the library's flags
and the variant's -D defines; `LSM_BLOCK_SPLIT` 1 runs no products, 2 moves
no state, 3 loads no weight blocks, 4 only loads, 5 loads nothing, 6 is the
kernel with clock64 stamps, printed as each part's cycles a CTA), points the
wrappers of ops/kernels/sparse_lif.py at each build in turn, and times B5
and B6 with
CUDA events at the cells' shapes on the configs[3] reservoir (10240
neurons, weights drawn on the card at scaled10k's mean weight, 10 % input
spikes): B5 at 2400 and 256 streams, B6 at 1024 streams over one 40-step
hop. Only the default variant computes the right answer; the others time
what is left when a part is taken away. Prints one line a variant and
shape beside the card's name and power limit, and writes every number as
JSON to --out (default chiprun_out/block_split.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from lsm_tpu_torch.config import ReservoirConfig  # noqa: E402
from lsm_tpu_torch.models import sparse  # noqa: E402
from lsm_tpu_torch.ops import _build  # noqa: E402
from lsm_tpu_torch.ops.kernels import sparse_lif as ksp  # noqa: E402

SPLITS = {"kernel": [], "stamps": ["LSM_BLOCK_SPLIT=6"], "no_state": ["LSM_BLOCK_SPLIT=2"],
          "no_weights": ["LSM_BLOCK_SPLIT=3"], "no_loads": ["LSM_BLOCK_SPLIT=5"],
          "loads_only": ["LSM_BLOCK_SPLIT=4"], "no_products": ["LSM_BLOCK_SPLIT=1"]}
STAMPS = ("consumer_wait", "consumer_products", "updater_wait", "consumer_total",
          "producer_wait", "producer_total", "items", "consumer_stash_wait")
MEAN_WEIGHT = 0.002963560740152995          # scaled10k's (benchmark/configs)
SHAPES = (("B5", 2400, 40), ("B5", 256, 40), ("B6", 1024, 40))


def build(name: str, defines: list) -> tuple:
    """(library path, ptxas's report on the 128-stream 8-bit body: its
    registers and spills, and any wgmma serialization it warns of)."""
    out = _build.BUILD_DIR / "split" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
           *(f"-D{d}" for d in defines), str(_build.CSRC_DIR / "sparse_lif.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    regs = [" ".join(x.strip() for x in log[i + 1:i + 4]) for i, line in enumerate(log)
            if "block_step_kernelILi128EhE" in line and "Compiling" in line and i + 3 < len(log)]
    warned = sorted({x.strip() for x in log if "wgmma" in x.lower()})
    return out, " | ".join(regs[:1] + warned)


def use(lib_path: Path) -> ctypes.CDLL:
    """Point B5's and B6's wrappers at this build's entry points."""
    lib = ctypes.CDLL(str(lib_path))
    for entry in (ksp._STATS, ksp._CHUNK):
        fn = getattr(lib, entry.name)
        fn.argtypes, fn.restype = entry._types
        entry._fn = fn
    return lib


def stamps(lib: ctypes.CDLL, ctas: int) -> dict:
    """The stamped build's per-CTA cycle counts of the last launch, as means
    over CTAs, and each consumer part's share of the consumer's cycles."""
    n = min(ctas, 4096)
    buf = (ctypes.c_longlong * (8 * n))()
    torch.cuda.synchronize()
    _build.check(lib.lsm_block_stamps(buf, n), "lsm_block_stamps")
    rows = [buf[8 * i:8 * i + 8] for i in range(n)]
    mean = {k: sum(r[i] for r in rows) / n for i, k in enumerate(STAMPS)}
    total = mean["consumer_total"] or 1.0
    mean.update({f"{k}_share": mean[k] / total
                 for k in ("consumer_wait", "consumer_products", "consumer_stash_wait")})
    return mean


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "block_split.json"))
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DEF[,DEF...]: another build to time beside the splits")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-splits", action="store_true",
                    help="time the kernel and the --variant builds only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("block_split.py times the card's kernels and needs a CUDA device")
    variants = {"kernel": []} if args.no_splits else dict(SPLITS)
    last = variants.pop("no_products", None)
    for v in args.variant:
        name, _, defs = v.partition("=")
        variants[name] = [d for d in defs.split(",") if d]
    if last is not None:
        variants["no_products"] = last
    with ThreadPoolExecutor(len(variants)) as pool:
        builds = dict(zip(variants, pool.map(lambda kv: build(*kv), variants.items())))

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    cfg = ReservoirConfig(num_neurons=10240, small_world_k=2048, sparse_partner_blocks=4,
                          mean_weight=MEAN_WEIGHT)
    sr = sparse.init_reservoir_sparse(cfg, 128, device=dev)
    ops, kw = sr.kernel_operands()
    ckw = {k: v for k, v in kw.items() if k != "n_win"}
    ckw.update(win_len=40, n_new_win=1)
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = {}
    for kernel, b, t in SHAPES:
        x = (torch.rand(b, 128, t, generator=g, device=dev) < 0.1).to(torch.uint8)
        state = (torch.zeros(b, 10240, device=dev),
                 torch.zeros(b, 10240, dtype=torch.int32, device=dev),
                 torch.zeros(b, 10240, device=dev))
        inputs[(kernel, b, t)] = (x, state)

    result = {"card": card, "variants": {}}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (path, regs) in builds.items():
        lib = use(path)
        rows = {"defines": variants[name], "ptxas": regs}
        for (kernel, b, t), (x, state) in inputs.items():
            t0 = time.perf_counter()
            try:
                if kernel == "B5":
                    ms = cuda_ms(lambda: ksp.sparse_lif_stats(x, *ops, **kw), args.reps)
                else:
                    ms = cuda_ms(lambda: ksp.sparse_lif_chunk(x, *ops, *state, **ckw),
                                 args.reps)
            except RuntimeError as err:          # the card's context is lost: stop here
                print(f"[split] {name:>14} {kernel} B={b:5d} failed after "
                      f"{time.perf_counter() - t0:.1f} s: {err}".splitlines()[0])
                raise
            rows[f"{kernel}_B{b}"] = {"ms": ms, "us_a_step": 1e3 * ms / t}
            print(f"[split] {name:>14} {kernel} B={b:5d} T={t}: {ms:8.3f} ms, "
                  f"{1e3 * ms / t:8.2f} us a step ({card})")
            if hasattr(lib, "lsm_block_stamps"):
                st = stamps(lib, sms)
                rows[f"{kernel}_B{b}"]["stamps"] = st
                print(f"[split] {name:>14} {kernel} B={b:5d} cycles a CTA: " + ", ".join(
                    f"{k} {v:.4g}" for k, v in st.items()))
        print(f"[split] {name:>14} ptxas: {regs}")
        result["variants"][name] = rows
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
