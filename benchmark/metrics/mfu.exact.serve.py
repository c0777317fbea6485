"""The exact serving hop's share of the card's peak, in %: every hop
classifies each stream's whole window with the batch path, so its work is
B1's and B2's counted work (counts/b1.py, counts/b2.py) and the
readout's for hops x streams windows, read through a copy of the run
marked as a batch run, against the traced window (lib/roofline.py's
step_share). None off the exact engine's runs (no `utterances`) or where
the window holds no device activity (a run without a card)."""

from benchmark.lib import roofline


def read(run: dict):
    if run["cell_kind"] != "serve" or "utterances" not in run or run["trace"]["busy_s"] <= 0.0:
        return None
    return roofline.step_share({**run, "cell_kind": "batch"}, ("b1", "b2"), "batch")
