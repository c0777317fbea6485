"""Milliseconds a serving hop in which the card idles while the program's
`lsm.kws.reservoir` span is the innermost one (B4 or B6 and their
wrappers' ops): lib/spans.py, per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.kws.reservoir", "idle_s")
