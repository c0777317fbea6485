"""The port's spans, and a trace writer.

`span(name)` marks a layer boundary. While no torch profiler records, it
returns one shared null context and costs only the profiler's enabled
probe. Inside a profiler window (`perfetto_trace`, or any
`torch.profiler.profile`) it is a `torch.profiler.record_function` range:
it lands in the same trace as the card's kernels and copies, on the same
clock, and each device operation is tied to the span that launched it
through its runtime call's correlation id. A span's parent is the span
that encloses it on the thread.

The spans, one at each layer boundary of the two paths:

  lsm.kws.step       ContinuousKWS.step, step_compact, step_active: one hop
  lsm.kws.ingest     host normalization and the host-to-device copy of
                     the wire chunk (also under stream and steps_fused)
  lsm.kws.frontend   decode, B3, window sums, dB, normalization, encoder
  lsm.kws.reservoir  B4 or B6 and their wrappers' ops
  lsm.kws.readout    ring pushes, the fold, features, scaler, readout
  lsm.kws.egress     the gather, the compact output and the host copy
  lsm.kws.gather     gather_streams on a mesh: the collective and its buffer
  lsm.frontend       featurize_batch, with its children
  lsm.frontend.spectrogram   wire decode, B1 (or mel), dB
  lsm.frontend.normalize     min-max and the zoom to time_bins
  lsm.frontend.encode        the hysteresis encoder and the redundancy repeat
  lsm.reservoir      extract_features (B2 or B5, and the features)
  lsm.readout        scaler.transform and logistic.predict

`perfetto_trace(path)` records the enclosed block, host ops and the card's
activity where CUDA is available, and writes it to `path` as a
Chrome/Perfetto JSON trace: an operator sees the spans of any call into
the library by wrapping the call in it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function` range named `name` while a torch profiler
    records; the shared null context otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def perfetto_trace(path: str) -> Iterator[torch.profiler.profile]:
    """Record the enclosed block (host ops, and the card's kernels where
    CUDA is available) and write it to `path` as a Chrome/Perfetto JSON
    trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
