#!/usr/bin/env python3
"""How close float32 forms of the gammatone cascade come to float64, on the CPU.

Emulates, in NumPy, kernel B1/B3's float32 arithmetic (csrc/gtgram.cu: the
delta-operator TDF2 with the TDF2 state at sub-block boundaries, each fmaf
rounded once) and two other float32 forms of Slaney's cascade: the plain
TDF2 with float32 b1, b2, and the TDF2 whose denominator is kept as
d1 = b1 + 2, e2 = 1 - b2. It prints, per form, the largest relative error
against the float64 cascade of the sub-block energies at >= 1e-4 and
>= 1e-2 of their (row, channel) peak, for the worst channel and channels
0-3, beside the plain twin (lsm_tpu's float32 block form,
`gtgram.sub_energy_plain`). A CPU emulation: it predicts the kernel's error
on the card, which chip_smoke.py measures.

    python3 tools/gtgram_numerics.py [--rows 12] [--g 80] [--channels 128]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lsm_tpu_torch.io import dataset  # noqa: E402
from lsm_tpu_torch.ops import gammatone as gt  # noqa: E402
from lsm_tpu_torch.ops.kernels import gtgram as kgt  # noqa: E402

F32, F64 = np.float32, np.float64


def fma(a, b, c):
    """float32 fmaf: the exact product and sum, rounded once."""
    return (a.astype(F64) * b.astype(F64) + c.astype(F64)).astype(F32)


def add(a, b):
    return (a.astype(F64) + b.astype(F64)).astype(F32)


def run(form: str, x: np.ndarray, fs: float, channels: int, g: int) -> np.ndarray:
    """Sub-block energies (n_sub, B, C) of `form` over x (B, S) from a zero
    state: "float64", "kernel", "tdf2" or "tdf2_delta_coeffs"."""
    n0, n1, b1, b2 = gt._section_coeffs(fs, channels, 50.0)
    B, S = x.shape
    shape = (B, channels)
    dt = F64 if form == "float64" else F32
    cst = lambda v: np.broadcast_to(np.asarray(v, F64).astype(dt), shape)  # noqa: E731
    q = gt.cascade_coeffs(fs, channels, 50.0)
    s1, s2 = [np.zeros(shape, dt) for _ in range(4)], [np.zeros(shape, dt) for _ in range(4)]
    out, e = [], np.zeros(shape, dt)
    for i in range(S):
        if form == "kernel" and i % g == 0:            # TDF2 -> delta state
            w1, w2 = list(s1), [add(s1[k], s2[k]) for k in range(4)]
        xv = np.broadcast_to(x[:, i:i + 1].astype(dt), shape)
        for k in range(4):
            if form == "float64":
                y = n0 * xv + s1[k]
                s1[k], s2[k] = n1[k] * xv - b1 * y + s2[k], -b2 * y
            elif form == "kernel":
                y = fma(cst(q[:, 0]), xv, w1[k])
                w1[k] = add(w1[k], fma(cst(-q[:, 1]), y, fma(cst(q[:, 3 + k]), xv, w2[k])))
                w2[k] = fma(cst(-q[:, 2]), y, fma(cst(q[:, 7 + k]), xv, w2[k]))
            elif form == "tdf2":
                y = fma(cst(n0), xv, s1[k])
                s1[k], s2[k] = fma(cst(-b1), y, fma(cst(n1[k]), xv, s2[k])), -cst(b2) * y
            else:                                        # tdf2_delta_coeffs
                y = fma(cst(n0), xv, s1[k])
                t = fma(np.full(shape, 2.0, F32), y, fma(cst(n1[k]), xv, s2[k]))
                s1[k], s2[k] = fma(cst(-(b1 + 2.0)), y, t), fma(cst(1.0 - b2), y, -y)
            xv = y
        e = xv * xv + e if form == "float64" else fma(xv, xv, e)
        if (i + 1) % g == 0:
            if form == "kernel":                         # delta -> TDF2 state
                s1, s2 = list(w1), [add(w2[k], -w1[k]) for k in range(4)]
            out.append(e)
            e = np.zeros(shape, dt)
    return np.stack(out)


def rel_err(e: np.ndarray, ref: np.ndarray, floor: float) -> np.ndarray:
    """Per channel: the largest |e - ref| / ref over the sub-block energies
    at >= floor of their (row, channel) peak."""
    keep = ref >= floor * ref.max(axis=0, keepdims=True)
    return np.where(keep, np.abs(e.astype(F64) - ref) / np.maximum(ref, 1e-300), 0.0).max((0, 1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=12)
    ap.add_argument("--g", type=int, default=80)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--fs", type=float, default=16000.0)
    args = ap.parse_args()
    audio, _ = dataset.synthetic_audio_batch_hard(1, 12, seed=42)
    x = np.ascontiguousarray(audio[:args.rows, : audio.shape[1] // args.g * args.g], F32)
    ref = run("float64", x, args.fs, args.channels, args.g)
    fb = gt.filterbank(args.fs, args.channels, 50.0, args.g, torch.device("cpu"))
    results = {"twin (block form)": kgt.sub_energy_plain(torch.as_tensor(x), fb).numpy()}
    for form in ("kernel", "tdf2", "tdf2_delta_coeffs"):
        results[form] = run(form, x, args.fs, args.channels, args.g)
    print(f"synthetic_audio_batch_hard(1, 12, seed=42)[:{args.rows}], fs {args.fs:.0f}, "
          f"g {args.g}, C {args.channels}; max relative error against float64, per channel")
    for name, e in results.items():
        for floor in (1e-4, 1e-2):
            r = rel_err(e, ref, floor)
            print(f"  {name:20s} >= {floor:g} of peak: worst {r.max():.3e} (channel "
                  f"{int(r.argmax())}); channels 0-3 " + " ".join(f"{v:.2e}" for v in r[:4]))


if __name__ == "__main__":
    main()
