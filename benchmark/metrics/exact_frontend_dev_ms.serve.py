"""Device milliseconds an exact serving hop of the batch front end that
StreamingKWS runs over every stream's trailing window: the program's
`lsm.frontend` span with everything nested in it (`dev_s_total`: the
wire decode, B1, dB, min-max, the zoom and the encoder), lib/spans.py,
per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.frontend", "dev_s_total")
