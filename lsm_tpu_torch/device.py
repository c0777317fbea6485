"""Explicit device choice for the port.

`--device cuda` on a machine without CUDA raises: nothing falls back to the
CPU silently. Resolving a device also pins the float32 matmul precision:
the gammatone state path must stay exact f32 (TF32 keeps ~3 decimal digits
and breaks near-unit-circle IIR states), so TF32 is turned off for both
cuBLAS and cuDNN.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """'cuda' / 'cuda:N' / 'cpu' -> torch.device; raises when CUDA is asked
    for and absent."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but torch.cuda.is_available() "
            "is False (pass --device cpu to run the plain PyTorch path)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(name)!r} (use cuda or cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
