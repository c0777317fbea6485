"""How `correct` is decided: the numbers that compare the program's output
with the plain reference's, and their limits.

The reservoir is a spiking network run at the edge of chaos: a drive
summed in another order moves a membrane by a rounding error, and where
that crosses the threshold one spike flips and the trajectories part. So
the reference does not run a whole trajectory beside the program's; each
stage is compared from the program's output of the stage before (the
batch path) or from the program's carried state before the hop (serving),
and the numbers are shares of what differs, whose limits were set from
sound runs and from the control (`limits/<cell>.json`, PERF.md).

A number with a limit is compared: it must be finite and at most its
limit. A number without one is printed as a reading. `correct` is false
when any compared number fails or when no answer was compared.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import torch


def rel_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row: the largest |a - b| over the row's largest |b| (a floor of
    1e-30 keeps a silent row finite)."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return (a - b).abs().amax(dim=1) / b.abs().amax(dim=1).clamp_min(1e-30)


def share_differ(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a != b).double().mean())


def l1_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """sum |a - b| over sum |b|."""
    return float((a.double() - b.double()).abs().sum() / b.double().abs().sum().clamp_min(1e-30))


def quantile(x: torch.Tensor, q: float) -> float:
    return float(torch.quantile(x.double().cpu(), q))


def batch_numbers(port: dict, ref_spikes, ref_feats_from_port, ref_logits_from_port,
                  ref_preds_from_audio) -> dict:
    """One checked batch step: the front end on the same audio, the
    reservoir and features from the program's spikes, the readout from
    the program's features, and the whole path's answers."""
    gap = rel_rows(port["features"], ref_feats_from_port)
    preds = port["preds"].to(ref_logits_from_port.device)
    return {
        "spike_flips": share_differ(port["spikes"], ref_spikes),
        "feature_gap_median": quantile(gap, 0.5),
        "feature_gap_p90": quantile(gap, 0.9),
        "feature_gap_max": float(gap.max()),
        "pred_mismatch": share_differ(preds, torch.argmax(ref_logits_from_port, dim=-1)),
        "pred_mismatch_audio": share_differ(preds, ref_preds_from_audio.to(preds.device)),
    }


def hop_numbers(port_after: dict, port_logits, ref_after: dict, ref_logits,
                threshold: float) -> dict:
    """One checked serving hop: the program's state after the hop and its
    logits against the reference's from the same state before it. The
    medians over streams are steady from seed to seed: a spike that one
    rounding flips parts a few streams' trajectories, not the median's."""
    seg = {k: v[-1] for k, v in port_after["segs"].items()}
    rseg = {k: v[-1] for k, v in ref_after["segs"].items()}
    lg = rel_rows(torch.as_tensor(port_logits, device=ref_logits.device), ref_logits)
    v_gap = (port_after["v"] - ref_after["v"]).abs()
    v_rows = v_gap.amax(dim=1) / threshold
    return {
        "iir_gap": float(rel_rows(port_after["iir"], ref_after["iir"]).max()),
        "tail_gap": float(rel_rows(port_after["tail"].transpose(0, 1),
                                   ref_after["tail"].transpose(0, 1)).max()),
        "hyst_flips": share_differ(port_after["hyst"], ref_after["hyst"]),
        "norm_gap_db": float(torch.maximum((port_after["norm_hi"] - ref_after["norm_hi"]).abs().max(),
                                           (port_after["norm_lo"] - ref_after["norm_lo"]).abs().max())),
        "spike_mismatch": share_differ(port_after["s_prev"], ref_after["s_prev"]),
        "membrane_moved": float((v_gap > 1e-3).double().mean()),
        "membrane_gap_median": quantile(v_rows, 0.5),
        "count_gap": l1_share(seg["counts"], rseg["counts"]),
        "window_gap": l1_share(port_after["win_ring"], ref_after["win_ring"]),
        "logit_gap_median": quantile(lg, 0.5),
        "logit_gap_p90": quantile(lg, 0.9),
        "logit_gap_max": float(lg.max()),
    }


def worst(readings: list) -> dict:
    """Each number's largest reading over the checked steps or hops (NaN
    if any reading is NaN)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            prev = out.get(k, v)
            out[k] = math.nan if math.isnan(prev) or math.isnan(v) else max(prev, v)
    return out


def load_limits(bench: Path, cell: str) -> dict:
    path = bench / "limits" / f"{cell}.json"
    if not path.is_file():
        return {}
    return {k: v["limit"] for k, v in json.loads(path.read_text())["numbers"].items()
            if v.get("limit") is not None}


def decide(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): checks maps each compared number to its value and
    limit. Prints every reading, then each compared number beside its limit
    as the last lines of stderr."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        passed = math.isfinite(value) and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    for name, value in numbers.items():
        if name not in limits:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        verdict = "ok" if math.isfinite(c["value"]) and c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} <= {c['limit']!r} {verdict}", file=sys.stderr)
    return ok, checks
