"""Device milliseconds a serving hop of the operations launched inside the
program's `lsm.kws.readout` span (the ring pushes, the fold, the
features, the scaler and the readout): lib/spans.py, per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.kws.readout", "dev_s")
