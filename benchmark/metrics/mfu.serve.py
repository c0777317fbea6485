"""The whole serving hop's share of the card's peak, in %: B3's, the
reservoir kernel's (B4 or B6) and the readout's counted work, against the
window (lib/roofline.py)."""

from benchmark.lib import roofline


def read(run: dict):
    return roofline.step_share(run, ("b3", "b4", "b6"), "serve")
