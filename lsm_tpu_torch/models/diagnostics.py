"""Reservoir health diagnostics (port of lsm_tpu/models/diagnostics.py).

Runs a few samples, measures per-neuron participation over the FULL
reservoir from the streaming `all_counts`, and classifies the regime with
the reference's thresholds: <40 % sub-critical, >98 % super-critical, else
edge of chaos. The report text is identical to the reference package's.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from lsm_tpu_torch.models.reservoir import Reservoir, simulate_batch

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


def run_network_diagnostics(
    res: Reservoir, spikes, n_samples: int = 5
) -> DiagnosticsReport:
    """Classify the regime from the first n_samples spike trains (a NumPy
    array or a tensor); the simulation runs on the reservoir's device."""
    batch = torch.as_tensor(spikes[:n_samples]).to(res.w_rec.device)
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
