"""Milliseconds a serving hop in which the card idles while the program's
`lsm.kws.gather` span is the innermost one (the host's side of the mesh
gather: the buffer's set-up and the collective's call): lib/spans.py, per
hop. None where the program opens no such span (one card, or a program
without it)."""

from benchmark.lib import spans

SPAN = "lsm.kws.gather"


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    red = spans.of_run(run)
    if red is None or SPAN not in red["spans"]:
        return None
    if red["spans"][SPAN]["count"] != run["hops"]:
        raise RuntimeError(f"{red['spans'][SPAN]['count']} {SPAN} spans in the traced window, "
                           f"but the run made {run['hops']} hops")
    return spans.per_unit(run, SPAN, "idle_s")
