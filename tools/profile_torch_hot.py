#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's 2400-utterance hot path on one GPU.

Run from the repository root:  python3 tools/profile_torch_hot.py [--out F] [--trace F]

Builds chip_smoke.py's hot path (featurize -> reservoir features -> scaler
-> predict, audio already on the card) and measures:
  - host-clock walls of 5 calls with the kernels, then 2 calls with both
    kernels' plain PyTorch twins swapped in, then 5 with the kernels again;
  - torch.profiler over 3 calls: the host wall, the device-busy time (the
    union of the CUDA events' intervals) and its share of the wall, the
    number of device events, and device time per kernel name.
Prints a summary beside the card's nvidia-smi name and power limit and
writes every number as JSON to --out (default chiprun_out/hot_profile.json).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from lsm_tpu_torch.device import resolve_device  # noqa: E402
from lsm_tpu_torch.ops.kernels import gtgram as kgt  # noqa: E402
from lsm_tpu_torch.ops.kernels import lif as klif  # noqa: E402


def walls(run, reps: int) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def with_plain_twins(run, reps: int) -> list:
    """Walls with the wrappers' module attributes pointed at the plain twins
    (gammatone.py and reservoir.py call them through the module)."""
    saved = kgt.sub_energy, klif.lif_stats
    kgt.sub_energy, klif.lif_stats = kgt.sub_energy_plain, klif.lif_stats_plain
    try:
        run()                                    # warm-up of the plain path
        return walls(run, reps)
    finally:
        kgt.sub_energy, klif.lif_stats = saved


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "hot_profile.json"))
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_hot: needs a CUDA device")
    dev = resolve_device("cuda")
    card = chip_smoke.gpu_line()
    hp = chip_smoke.hot_path(dev)
    hp.run()
    rec = {"card": card, "n": hp.n}
    rec["wall_s_kernel"] = walls(hp.run, 5)
    rec["wall_s_plain"] = with_plain_twins(hp.run, 2)
    rec["wall_s_kernel_after"] = walls(hp.run, 5)
    rec["profile"] = chip_smoke.device_profile(hp.run, 3, args.trace)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))

    p = rec["profile"]
    kern = rec["wall_s_kernel"] + rec["wall_s_kernel_after"]
    print(card)
    print(f"[profile] {hp.n} utt: kernel walls {min(kern) * 1e3:.2f}-{max(kern) * 1e3:.2f} ms, "
          f"plain-twin walls " + ", ".join(f"{w * 1e3:.1f}" for w in rec["wall_s_plain"]) + " ms")
    print(f"[profile] {p['calls']} calls: wall {p['profiled_wall_s'] * 1e3:.2f} ms, device busy "
          f"{p['device_busy_us'] / 1e3:.2f} ms ({100 * p['busy_share_of_wall']:.1f} %), "
          f"{p['n_device_events']} device events")
    for t in p["top_device"][:8]:
        print(f"[profile]   {t['us'] / 1e3 / p['calls']:9.3f} ms/call x{t['count']:4d}  {t['name']}")
    print(f"[profile] wrote {args.out}")


if __name__ == "__main__":
    main()
