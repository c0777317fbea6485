"""Kernel B1: gammatone sub-block energies (csrc/gtgram.cu).

Replaces lsm_tpu/ops/pallas/gtgram_kernel.py:70 `_energy_kernel` (via
`gtgram_pallas`) together with its XLA phase 1,
lsm_tpu/ops/gammatone.py:345 `gtgram_state_energy`. The TPU split the work
into two phases only to avoid a Mosaic relayout; on Hopper one kernel runs
the exact block recurrence: one thread per (batch row, channel) carries the
8-dim cascade state in registers, the channel's (g+8, g+8) block system
(~31 KB at g=80) sits in shared memory, and each sub-block costs
(g+8)^2 float32 FMAs.

What bounds it on an H100: float32 FMA issue on the CUDA cores (no tensor
cores: the state path must stay exact f32, so no TF32 and no bf16) and the
shared-memory operand reads that feed them (one 16-byte broadcast load per
four FMAs). The waveform is re-read once per channel; CTAs of one batch
tile over all channels are scheduled together, so those re-reads hit L2.
At 2400 utterances the kernel does ~0.95 TFLOP of FMAs.
"""

from __future__ import annotations

import ctypes

import torch

from lsm_tpu_torch.ops import _build

G = 80                   # samples per sub-block the kernel is compiled for
_BT = 64                 # batch rows per CTA (csrc/gtgram.cu)

launches = 0             # kernel launches (the plain twin does not count)


def sub_energy_plain(wave: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: the exact block scan of lsm_tpu's
    `gtgram_iir_scan`, op for op. wave (B, n_sub*g) f32, kmat (C, g+8, g+8)
    f32 -> sub-block energies (n_sub, C, B) f32."""
    B, S = wave.shape
    C, Z, _ = kmat.shape
    g = Z - 8
    n_sub = S // g
    blocks = wave.view(B, n_sub, g)
    # Flattened per-channel maps, the reference's layouts:
    #   w_yx[l, m*C + c] = M_yx[c, l, m];  w_xs[l, s*C + c] = M_xs[c, l, s]
    w_yx = kmat[:, :g, :g].permute(2, 1, 0).reshape(g, g * C)
    w_xs = kmat[:, g:, :g].permute(2, 1, 0).reshape(g, 8 * C)
    m_sy_t = kmat[:, :g, g:].permute(2, 1, 0).contiguous()      # (8, g, C)
    m_ss_t = kmat[:, g:, g:].permute(2, 1, 0).contiguous()      # (8, 8, C)
    state = torch.zeros(B, 8, C, dtype=torch.float32, device=wave.device)
    out = torch.empty(n_sub, C, B, dtype=torch.float32, device=wave.device)
    for k in range(n_sub):
        x = blocks[:, k]
        y = (x @ w_yx).view(B, g, C)
        new_state = (x @ w_xs).view(B, 8, C)
        for s in range(8):
            col = state[:, s, :][:, None, :]
            y = y + col * m_sy_t[s][None, :, :]
            new_state = new_state + col * m_ss_t[s][None, :, :]
        out[k] = torch.sum(y * y, dim=1).T
        state = new_state
    return out


def _check(wave: torch.Tensor, kmat: torch.Tensor) -> None:
    if wave.dtype != torch.float32 or kmat.dtype != torch.float32:
        raise TypeError(f"gtgram sub_energy wants float32, got {wave.dtype}, {kmat.dtype}")
    if wave.dim() != 2 or kmat.dim() != 3 or kmat.shape[1] != kmat.shape[2]:
        raise ValueError(f"bad shapes wave {tuple(wave.shape)} kmat {tuple(kmat.shape)}")
    g = kmat.shape[1] - 8
    if wave.shape[1] % g:
        raise ValueError(f"wave length {wave.shape[1]} is not a multiple of g={g}")
    if wave.device != kmat.device:
        raise ValueError(f"wave on {wave.device}, kmat on {kmat.device}")
    if not (wave.is_contiguous() and kmat.is_contiguous()):
        raise ValueError("gtgram sub_energy wants contiguous tensors")


def sub_energy(wave: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    """Sub-block energies (n_sub, C, B): kernel B1 on CUDA, the plain twin
    on CPU."""
    global launches
    _check(wave, kmat)
    if wave.device.type == "cpu":
        return sub_energy_plain(wave, kmat)
    if wave.device.type != "cuda":
        raise ValueError(f"unsupported device {wave.device}")
    g = kmat.shape[1] - 8
    if g != G:
        raise ValueError(f"kernel B1 is compiled for g={G}, got g={g}")
    if wave.data_ptr() % 16 or kmat.data_ptr() % 16:
        raise ValueError("kernel B1 loads float4: tensors must be 16-byte aligned")
    B, S = wave.shape
    C = kmat.shape[0]
    n_sub = S // g
    out = torch.empty(n_sub, C, B, dtype=torch.float32, device=wave.device)
    fn = _build.function("lsm_gtgram_sub_energy", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream(wave.device).cuda_stream
        err = fn(wave.data_ptr(), kmat.data_ptr(), out.data_ptr(),
                 B, C, n_sub, stream)
    _build.check(err, "lsm_gtgram_sub_energy")
    launches += 1
    return out
