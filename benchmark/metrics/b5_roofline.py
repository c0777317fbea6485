"""Kernel B5's share of its roofline, in %: the least time of its
counted work (counts/b5.py) over its device time in the traced window."""

from benchmark.lib import roofline


def read(run: dict):
    return roofline.share(run, "b5")
