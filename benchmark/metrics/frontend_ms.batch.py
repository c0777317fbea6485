"""Milliseconds a batch step spends in featurize_batch (front end: models/frontend.py, ops/gammatone.py + B1, ops/hysteresis.py): CUDA events recorded
around the call in every traced step, averaged over the traced window."""


def read(run: dict):
    if run["cell_kind"] != "batch":
        return None
    return float(run["stage_ms"]["frontend"])
