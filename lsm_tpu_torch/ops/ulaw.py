"""G.711 mu-law decode on the device (port of lsm_tpu/ops/ulaw.py).

Bit-equal to `lsm_tpu.ops.ulaw.decode_ulaw_device`: integer ops on int32,
one final float32 scale by the decoders' exact /32768.
"""

from __future__ import annotations

import torch

_BIAS = 0x84        # 132, the CCITT segment bias


def decode_ulaw(ulaw: torch.Tensor) -> torch.Tensor:
    """uint8 mu-law -> float32 samples in [-1, 1)."""
    u = torch.bitwise_not(ulaw.to(torch.int32)) & 0xFF
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = (((mant << 3) + _BIAS) << exp) - _BIAS
    lin = torch.where((u & 0x80) != 0, -mag, mag)
    return lin.to(torch.float32) / 32768.0
