"""What kernel B1/B3's state conversion costs against float64, on the
configs[2] corpus, emulated on the CPU (ROADMAP C5, fixed).

Kernel B1/B3 (csrc/gtgram.cu) runs each (row, channel) cascade in the
delta-operator TDF2 and converts its state to the block form's TDF2 state
and back once every period of `conv_sub` sub-blocks (one 1600-sample
serving hop by default), so that chained B3 hops are bit-equal to one call.
This emulates the kernel's float32 arithmetic in NumPy (each fmaf rounded
once) as the kernel now runs it ("kernel": a conversion every `--period`
samples), as it ran before ("per_sub_block": a conversion every sub-block)
and without conversions ("no_conversion"), on the first rows of
`synthetic_audio_batch(30, 35, seed=77)` at 256 filters, and prints per
channel the largest relative error against the float64 cascade of the
sub-block energies at >= 1e-4 of their (row, channel) peak: chip_smoke.py
phase 15's measure.

    python -m lsm_tpu_torch.tools.gtgram_conversion [--rows 256]
        [--channels 0 1 2 3] [--samples 16000] [--period 1600]
"""

from __future__ import annotations

import argparse

import numpy as np

F32, F64 = np.float32, np.float64


def _fma(a, b, c):
    return (a.astype(F64) * b.astype(F64) + c.astype(F64)).astype(F32)


def _add(a, b):
    return (a.astype(F64) + b.astype(F64)).astype(F32)


FORMS = ("kernel", "per_sub_block", "no_conversion")


def sub_energies(form: str, x: np.ndarray, q: np.ndarray, sec: tuple, g: int,
                 period: int = 1600) -> np.ndarray:
    """Sub-block energies (n_sub, B, C) of x (B, S) from a zero state:
    "float64" (Slaney's TDF2 on float64 `sec` = (n0, n1, b1, b2)), or the
    delta form on the float32 of `q`, (C, 11) `gammatone.cascade_coeffs`
    rows, converting its state every `period` samples ("kernel", a multiple
    of g), every g samples ("per_sub_block") or never ("no_conversion")."""
    if form not in ("float64",) + FORMS:
        raise ValueError(f"unknown form {form!r}")
    every = {"kernel": period, "per_sub_block": g}.get(form)
    if every is not None and (every <= 0 or every % g):
        raise ValueError(f"period {every} is not a positive multiple of g = {g}")
    shape = (x.shape[0], q.shape[0])
    dt = F64 if form == "float64" else F32
    n0, b1, b2 = (np.broadcast_to(v, shape) for v in (sec[0], sec[2], sec[3]))
    n1 = [np.broadcast_to(sec[1][k], shape) for k in range(4)]
    c = [np.broadcast_to(q[:, j].astype(F32), shape) for j in range(q.shape[1])]
    s1 = [np.zeros(shape, dt) for _ in range(4)]
    s2 = [np.zeros(shape, dt) for _ in range(4)]
    w1, w2 = list(s1), list(s2)
    out, e = [], np.zeros(shape, dt)
    for i in range(x.shape[1]):
        if every is not None and i % every == 0:       # TDF2 -> delta state
            w1, w2 = list(s1), [_add(s1[k], s2[k]) for k in range(4)]
        xv = np.broadcast_to(x[:, i:i + 1].astype(dt), shape)
        for k in range(4):
            if form == "float64":
                y = n0 * xv + s1[k]
                s1[k], s2[k] = n1[k] * xv - b1 * y + s2[k], -b2 * y
            else:
                y = _fma(c[0], xv, w1[k])
                w1[k] = _add(w1[k], _fma(-c[1], y, _fma(c[3 + k], xv, w2[k])))
                w2[k] = _fma(-c[2], y, _fma(c[7 + k], xv, w2[k]))
            xv = y
        e = xv * xv + e if form == "float64" else _fma(xv, xv, e)
        if every is not None and (i + 1) % every == 0:  # delta -> TDF2 state
            s1, s2 = list(w1), [_add(w2[k], -w1[k]) for k in range(4)]
        if (i + 1) % g == 0:
            out.append(e)
            e = np.zeros(shape, dt)
    return np.stack(out)


def worst_by_channel(e: np.ndarray, ref: np.ndarray) -> np.ndarray:
    keep = ref >= 1e-4 * ref.max(axis=0, keepdims=True)
    rel = np.abs(e.astype(F64) - ref) / np.maximum(ref, 1e-300)
    return np.where(keep, rel, 0.0).max(axis=(0, 1))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.tools.gtgram_conversion")
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--channels", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--samples", type=int, default=16000,
                    help="Samples of each row to run (a multiple of the sub-block).")
    ap.add_argument("--period", type=int, default=1600,
                    help="Samples between the kernel's state conversions (a multiple "
                         "of the sub-block; one serving hop by default).")
    args = ap.parse_args(argv)

    from lsm_tpu_torch.config import FrontendConfig
    from lsm_tpu_torch.io.dataset import synthetic_audio_batch
    from lsm_tpu_torch.ops import gammatone as gt

    fc = FrontendConfig(n_filters=256)
    hop_time = fc.num_samples / (fc.sample_rate * fc.time_bins)
    nwin, hop, _ = gt.gtgram_strides(fc.sample_rate, fc.gt_window_time, hop_time,
                                     fc.num_samples)
    g = int(np.gcd(nwin, hop))
    fs, ch = float(fc.sample_rate), np.asarray(args.channels)
    n0, n1, b1, b2 = gt._section_coeffs(fs, fc.n_filters, fc.gt_f_min)
    sec = (n0[ch], n1[:, ch], b1[ch], b2[ch])
    q = gt.cascade_coeffs(fs, fc.n_filters, fc.gt_f_min)[ch]
    audio, _ = synthetic_audio_batch(30, 35, seed=77)
    x = np.ascontiguousarray(audio[:args.rows, :args.samples // g * g], F32)
    ref = sub_energies("float64", x, q, sec, g)
    print(f"synthetic_audio_batch(30, 35, seed=77)[:{args.rows}], {x.shape[1]} samples, "
          f"g {g}, 256 filters, kernel period {args.period} samples; worst relative error "
          "against float64 at >= 1e-4 of peak")
    result = {}
    for form in FORMS:
        result[form] = worst_by_channel(sub_energies(form, x, q, sec, g, args.period), ref)
        print(f"  {form:14s} " + " ".join(f"ch{c} {v:.3e}" for c, v in
                                            zip(args.channels, result[form])))
    return result


if __name__ == "__main__":
    main()
