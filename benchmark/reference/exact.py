"""The plain reference of the exact serving hop (the program's
StreamingKWS): each stream's trailing window of num_samples float32
samples shifted by the hop's wire chunk (int16 / 32768, then
concatenated), then the batch path on the window (engines.Batch).
Nothing here imports the program.

`Control` is the reference in the program's place, engines.Batch one
precision below each that the configuration states (`lower=True`, as
controls.py makes the other cells' controls). The shift is exact in any
precision, so the control's windows are the reference's.
"""

from __future__ import annotations

import torch

from benchmark.reference import engines


def shift(window: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """(B, W) float32 windows and a (B, L) int16 or float32 wire chunk ->
    the windows after the hop: the oldest L samples out, the chunk in."""
    new = chunk.float() / 32768.0 if chunk.dtype == torch.int16 else chunk.float()
    return torch.cat([window[:, chunk.shape[1]:], new], dim=1)


class Control:
    """The exact hop at the lower precision, with the interface of the
    program's wrapper (loops/serve_exact.py `Port`)."""

    def __init__(self, config: dict, weights: dict, device, streams: int):
        self.batch = engines.Batch(config, weights, device, lower=True)
        self.buffer = torch.zeros(streams, self.batch.frontend.n_samples, device=device)

    def stages(self, window: torch.Tensor) -> dict:
        sp = self.batch.spikes(window)
        f = self.batch.features(sp)
        return {"spikes": sp, "features": f, "logits": self.batch.logits(f)}

    def step(self, chunk):
        self.buffer = shift(self.buffer, torch.as_tensor(chunk).to(self.buffer.device))
        return self.stages(self.buffer)["logits"].cpu().numpy()

    def window(self) -> torch.Tensor:
        return self.buffer
