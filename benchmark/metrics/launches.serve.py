"""Kernel launches, copies and sets a serving hop: the CUDA runtime and
driver calls `cudaLaunchKernel*`, `cuLaunchKernel*`, `cudaMemcpy*` and
`cudaMemset*` inside the program's `lsm.kws.step` span and the spans
nested in it (lib/spans.py), per hop."""

from benchmark.lib import spans


def read(run: dict):
    if run["cell_kind"] != "serve":
        return None
    return spans.per_unit(run, "lsm.kws.step", "launches_total", scale=1.0)
