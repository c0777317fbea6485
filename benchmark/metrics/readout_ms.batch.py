"""Milliseconds a batch step spends in scaler.transform + logistic.predict (readout): CUDA events recorded
around the call in every traced step, averaged over the traced window."""


def read(run: dict):
    if run["cell_kind"] != "batch":
        return None
    return float(run["stage_ms"]["readout"])
