"""The control: the reference put in the program's place, each stage one
precision below what the configuration states (engines.py): TF32 for the
cascade's and the readout's float32 products with TF32 off (the step a
port is most often tempted by: turning TF32 on), fp8 for the reservoir's
bf16 weights and bf16 for its float32 membrane (the step that would tempt
a change to the bytes-bound serving kernels). Same interface as
benchmark/loops/port.py's `Batch` and `Serve`.
"""

from __future__ import annotations

import torch

from benchmark.reference import engines


class Serve:
    def __init__(self, config, weights, device, streams, chunk_len, decay):
        self.ref = engines.Stream(config, weights, device, chunk_len, decay, lower=True)
        self.n, self.device = streams, device
        self.st = self.ref.init_state(streams)

    def step(self, chunk):
        self.st, logits, _, _ = self.ref.hop(self.st, torch.as_tensor(chunk).to(self.device))
        return logits.cpu().numpy()

    def state(self) -> dict:
        return self.st

    def reset(self) -> None:
        self.st = self.ref.init_state(self.n)


def make(kind: str, config: dict, weights: dict, device, **kw):
    if kind == "batch":
        return engines.Batch(config, weights, device, lower=True)
    return Serve(config, weights, device, **kw)
