"""Device milliseconds a batch step of the operations launched inside the
program's `lsm.frontend.stft` span (the framing, the window product, the rFFT
and the power: ops/stft.py): lib/spans.py, per step.
None where the program opens no such span (the gammatone front end, or a
program without the mel spans)."""

from benchmark.lib import spans

SPAN = "lsm.frontend.stft"


def read(run: dict):
    if run["cell_kind"] != "batch":
        return None
    red = spans.of_run(run)
    if red is None or SPAN not in red["spans"]:
        return None
    return spans.per_unit(run, SPAN, "dev_s")
