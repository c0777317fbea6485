"""Device milliseconds a batch step of the operations launched inside the
program's `lsm.frontend.encode` span (the hysteresis encoder and the
redundancy repeat): lib/spans.py, per step."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "batch":
        return None
    return spans.per_unit(run, "lsm.frontend.encode", "dev_s")
