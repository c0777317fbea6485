"""The whole batch step's share of the card's peak, in %, over the kernels
the cell runs, chosen from the run's shape: the front end's (B1, or the
mel spectrogram's counted work) and the reservoir's (B2 dense, B5
block-sparse), with the readout's, against the window
(lib/roofline.py's step_share). None where the window holds no device
activity (a run without a card)."""

from benchmark.lib import roofline


def read(run: dict):
    if run["cell_kind"] != "batch" or run["trace"]["busy_s"] <= 0.0:
        return None
    sh = run["shape"]
    front = "melspec" if sh.get("filterbank") == "mel" else "b1"
    reservoir = "b5" if "out_degree" in sh else "b2"
    return roofline.step_share(run, (front, reservoir), "batch")
