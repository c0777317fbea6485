"""Milliseconds a serving hop in which the card idles while the program's
`lsm.kws.ingest` span is the innermost one (the host's normalization of
the wire chunk and its copy to the card): lib/spans.py, per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.kws.ingest", "idle_s")
