"""Device milliseconds an exact serving hop of the operations launched
inside the program's `lsm.kws.window` span (the on-device decode of the
wire chunk and the shift of each stream's trailing window; StreamingKWS
only): lib/spans.py, per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.kws.window", "dev_s")
