"""Milliseconds a serving hop in which the card idles while the program's
`lsm.kws.frontend` span is the innermost one (decode, B3, the window
sums, dB, the running normalization and the hysteresis encoder):
lib/spans.py, per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.kws.frontend", "idle_s")
