"""Device milliseconds a batch step of the operations launched inside the
program's `lsm.frontend.normalize` span (min-max and the zoom's
gathers): lib/spans.py, per step."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "batch":
        return None
    return spans.per_unit(run, "lsm.frontend.normalize", "dev_s")
