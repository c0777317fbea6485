"""Milliseconds a serving hop in which the card idles while the program's
`lsm.kws.readout` span is the innermost one (the ring pushes, the fold,
the features, the scaler and the readout): lib/spans.py, per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.kws.readout", "idle_s")
