"""The mel spectrogram's share of its roofline, in %: the least time of
its counted work (counts/melspec.py) over the device time of the
program's `lsm.frontend.spectrogram` span with everything nested in it
(`dev_s_total`), so that it reads the same work whatever implements the
stage. None off the mel front end or without the program's spans."""

from benchmark.lib import roofline, spans


def read(run: dict):
    work = roofline.counts("melspec").work(run)
    if work is None:
        return None
    seconds = spans.per_unit(run, "lsm.frontend.spectrogram", "dev_s_total", scale=1.0)
    if not seconds:
        return None
    return 100.0 * roofline.least_s(work) / (seconds * run["steps"])
