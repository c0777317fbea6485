"""Device milliseconds a serving hop of the operations launched inside the
program's `lsm.kws.ingest` span (the host's normalization of the wire
chunk and its copy to the card): lib/spans.py, per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.kws.ingest", "dev_s")
