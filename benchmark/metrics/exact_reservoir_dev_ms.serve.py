"""Device milliseconds an exact serving hop of the batch reservoir that
StreamingKWS runs over every stream's trailing window: the program's
`lsm.reservoir` span with everything nested in it (`dev_s_total`: B2 and
the features), lib/spans.py, per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.reservoir", "dev_s_total")
