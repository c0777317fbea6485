"""What the harness shares: traffic, weights, clocks and traces, the check."""

import importlib.util
from pathlib import Path


def load_module(path: Path):
    """A harness file by path: the per-layer metrics' readers and the
    kernels' counts, whose names may hold dots."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
