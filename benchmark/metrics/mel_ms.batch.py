"""Device milliseconds a batch step of the operations launched inside the
program's `lsm.frontend.mel` span (the filterbank product and power_to_db:
ops/mel.py, ops/db.py): lib/spans.py, per step.
None where the program opens no such span (the gammatone front end, or a
program without the mel spans)."""

from benchmark.lib import spans

SPAN = "lsm.frontend.mel"


def read(run: dict):
    if run["cell_kind"] != "batch":
        return None
    red = spans.of_run(run)
    if red is None or SPAN not in red["spans"]:
        return None
    return spans.per_unit(run, SPAN, "dev_s")
