"""Device milliseconds a batch step of the operations launched inside the
program's `lsm.frontend.spectrogram` span (the wire decode, B1 and the
dB floor): lib/spans.py, per step."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "batch":
        return None
    return spans.per_unit(run, "lsm.frontend.spectrogram", "dev_s")
