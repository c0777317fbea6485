"""G.711 mu-law: the host encoder (NumPy) and the device decoder
(port of lsm_tpu/ops/ulaw.py).

The CCITT tables: encode clips to +-32635, bias 0x84 = 132, 8 exponent
segments. `encode_ulaw` is byte-equal to lsm_tpu's on all 65536 int16
values; `decode_ulaw` is bit-equal to `lsm_tpu.ops.ulaw.decode_ulaw_device`:
integer ops on int32, one final float32 scale by the decoders' exact /32768.
"""

from __future__ import annotations

import numpy as np
import torch

_BIAS = 0x84        # 132, the CCITT segment bias
_CLIP = 32635


def encode_ulaw(pcm: np.ndarray) -> np.ndarray:
    """int16 linear PCM -> uint8 mu-law (host, vectorized)."""
    x = np.asarray(pcm)
    if x.dtype != np.int16:
        raise TypeError(f"encode_ulaw expects int16 PCM, got {x.dtype}")
    x = x.astype(np.int32)
    sign = np.where(x < 0, 0x80, 0)
    mag = np.minimum(np.abs(x), _CLIP) + _BIAS
    # exponent = highest set bit of mag in [7..14] minus 7
    exp = (np.floor(np.log2(mag)).astype(np.int32) - 7).clip(0, 7)
    mant = (mag >> (exp + 3)) & 0x0F
    return (~(sign | (exp << 4) | mant)).astype(np.uint8)


def encode_ulaw_f32(audio: np.ndarray) -> np.ndarray:
    """float32 samples in [-1, 1] -> uint8 mu-law through the int16 wire
    (io/wav.to_pcm16_wire, the one host float -> int16 quantization)."""
    from lsm_tpu_torch.io.wav import to_pcm16_wire

    return encode_ulaw(to_pcm16_wire(audio))


def decode_ulaw(ulaw: torch.Tensor) -> torch.Tensor:
    """uint8 mu-law -> float32 samples in [-1, 1)."""
    u = torch.bitwise_not(ulaw.to(torch.int32)) & 0xFF
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = (((mant << 3) + _BIAS) << exp) - _BIAS
    lin = torch.where((u & 0x80) != 0, -mag, mag)
    return lin.to(torch.float32) / 32768.0
