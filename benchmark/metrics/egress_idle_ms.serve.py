"""Milliseconds a serving hop in which the card idles while the program's
`lsm.kws.egress` span is the innermost one (the gather and the logits'
copy to the host, after the card's last operation of the hop):
lib/spans.py, per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.kws.egress", "idle_s")
