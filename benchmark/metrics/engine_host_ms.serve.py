"""Milliseconds of a serving hop in which the card is idle: the host's
own share of the hop (ingest, launches, the fold's small ops, egress).
Every device operation of a hop runs inside its wall, which ends with the
logits on the host, so this is the sum of the traced hops' walls less the
device-busy time, over the hops."""


def read(run: dict):
    if run["cell_kind"] != "serve" or run["hops"] == 0:
        return None
    return 1e3 * (run["hop_walls_s"] - run["trace"]["busy_s"]) / run["hops"]
