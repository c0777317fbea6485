"""Device milliseconds a serving hop of the operations launched inside the
program's `lsm.kws.reservoir` span (B4 or B6 and their wrappers' ops):
lib/spans.py, per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.kws.reservoir", "dev_s")
