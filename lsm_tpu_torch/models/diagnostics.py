"""Reservoir health diagnostics (port of lsm_tpu/models/diagnostics.py).

Runs a few samples, measures per-neuron participation over the FULL
reservoir from the streaming `all_counts`, and classifies the regime with
the reference's thresholds: <40 % sub-critical, >98 % super-critical, else
edge of chaos. `serving_report` builds the same verdict from per-stream
counts a serving engine already carries. The report texts are identical to
the reference package's.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from lsm_tpu_torch.models.reservoir import simulate_batch

SUB_CRITICAL = "SUB-CRITICAL"
SUPER_CRITICAL = "SUPER-CRITICAL"
EDGE_OF_CHAOS = "EDGE OF CHAOS"


def classify_regime(avg_participation: float) -> tuple:
    """(regime, advice) from the average participation in percent."""
    if avg_participation < 40.0:
        return (
            SUB_CRITICAL,
            "Recommendation: INCREASE multiplier or DECREASE threshold.",
        )
    if avg_participation > 98.0:
        return SUPER_CRITICAL, "Recommendation: DECREASE multiplier."
    return (
        EDGE_OF_CHAOS,
        "(Ideal is 80-95% participation with low firing rates)",
    )


@dataclasses.dataclass
class DiagnosticsReport:
    participation: List[float]       # percent of neurons firing >= 1, per sample
    dead_neurons: List[int]
    avg_spikes_per_neuron: List[float]
    avg_participation: float
    regime: str
    advice: str

    def render(self) -> str:
        lines = ["=" * 40, "RUNNING NETWORK DIAGNOSTICS", "=" * 40]
        for i, (p, d, a) in enumerate(
            zip(self.participation, self.dead_neurons, self.avg_spikes_per_neuron)
        ):
            lines.append(
                f"Sample {i + 1}: Active: {p:.1f}% | Dead: {d} | "
                f"Avg Spikes/Neuron: {a:.2f}"
            )
        lines += [
            "-" * 40,
            "DIAGNOSTIC RESULT:",
            f"   Average Participation: {self.avg_participation:.1f}%",
            f"   STATUS: {self.regime}",
            f"   {self.advice}",
            "=" * 40,
        ]
        return "\n".join(lines)


def run_network_diagnostics(res, spikes, n_samples: int = 5) -> DiagnosticsReport:
    """Classify the regime from the first n_samples spike trains (a NumPy
    array or a tensor) for a dense `Reservoir` (kernel B2) or a
    `SparseReservoir` (B5); the simulation runs on the reservoir's device."""
    batch = torch.as_tensor(spikes[:n_samples]).to(res.w_in.device)
    counts = simulate_batch(res, batch)["all_counts"].cpu().numpy()   # (n, N)
    total = res.n_neurons

    participation, dead, avg_rate = [], [], []
    for row in counts:
        active = int(np.count_nonzero(row))
        participation.append(active / total * 100.0)
        dead.append(total - active)
        avg_rate.append(float(row.mean()))

    avg_part = float(np.mean(participation))
    regime, advice = classify_regime(avg_part)
    return DiagnosticsReport(
        participation=participation,
        dead_neurons=dead,
        avg_spikes_per_neuron=avg_rate,
        avg_participation=avg_part,
        regime=regime,
        advice=advice,
    )


@dataclasses.dataclass
class ServingDiagnosticsReport:
    """Reservoir health measured on live serving traffic. Per-stream rows
    cover the selected streams only; the verdict and advice use the batch
    report's thresholds. `scope` names the participation denominator:
    "full" (the whole reservoir) or "output" (the output neurons, an
    exchangeable random subset, so the percentage estimates the full
    figure). A silent stream reads sub-critical by nature."""

    stream_idx: np.ndarray          # (n_sel,) engine slots the rows describe
    participation: np.ndarray       # (n_sel,) % of neurons firing >= 1
    spikes_per_neuron: np.ndarray   # (n_sel,) mean spikes/neuron over window
    dead_neurons: np.ndarray        # (n_sel,) int
    scope: str                      # "full" | "output"
    n_neurons: int                  # the participation denominator
    avg_participation: float
    regime: str
    advice: str

    def render(self, max_rows: int = 8) -> str:
        lines = ["=" * 40, "SERVING RESERVOIR DIAGNOSTICS", "=" * 40,
                 f"Streams: {len(self.stream_idx)} | Neuron scope: "
                 f"{self.scope} ({self.n_neurons})"]
        for i in range(min(max_rows, len(self.stream_idx))):
            lines.append(
                f"Stream {int(self.stream_idx[i])}: Active: "
                f"{self.participation[i]:.1f}% | Dead: "
                f"{int(self.dead_neurons[i])} | Avg Spikes/Neuron: "
                f"{self.spikes_per_neuron[i]:.2f}"
            )
        if len(self.stream_idx) > max_rows:
            lines.append(f"... ({len(self.stream_idx) - max_rows} more)")
        lines += [
            "-" * 40,
            "DIAGNOSTIC RESULT:",
            f"   Average Participation: {self.avg_participation:.1f}%",
            f"   STATUS: {self.regime}",
            f"   {self.advice}",
            "=" * 40,
        ]
        return "\n".join(lines)


def serving_report(
    active: np.ndarray,       # (n_streams,) neurons firing >= 1, per stream
    total: np.ndarray,        # (n_streams,) total spikes, per stream
    n_neurons: int,
    scope: str,
    stream_idx=None,
) -> ServingDiagnosticsReport:
    """A ServingDiagnosticsReport from per-stream count reductions;
    `stream_idx` selects the streams it describes and averages over (None =
    all), so callers can leave idle slots out."""
    active = np.asarray(active)
    total = np.asarray(total)
    if stream_idx is None:
        sel = np.arange(active.shape[0])
    else:
        sel = np.asarray(stream_idx, np.int64).reshape(-1)
    if sel.size == 0:
        raise ValueError(
            "serving diagnostics over zero streams — select at least one "
            "(an empty pool has no live traffic to diagnose)"
        )
    part = active[sel].astype(np.float64) / n_neurons * 100.0
    avg_part = float(part.mean())
    regime, advice = classify_regime(avg_part)
    return ServingDiagnosticsReport(
        stream_idx=sel,
        participation=part,
        spikes_per_neuron=total[sel].astype(np.float64) / n_neurons,
        dead_neurons=(n_neurons - active[sel]).astype(np.int64),
        scope=scope,
        n_neurons=int(n_neurons),
        avg_participation=avg_part,
        regime=regime,
        advice=advice,
    )
