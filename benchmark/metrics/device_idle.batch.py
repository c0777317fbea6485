"""Share of the traced window in which no operation ran on the card, in %."""


def read(run: dict):
    if run["cell_kind"] != "batch":
        return None
    tr = run["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
