"""The whole batch step's share of the card's peak, in %: B1's and B2's
counted work and the readout's, against the window (lib/roofline.py)."""

from benchmark.lib import roofline


def read(run: dict):
    return roofline.step_share(run, ("b1", "b2"), "batch")
