"""Kernels B1 and B3: gammatone sub-block energies (csrc/gtgram.cu).

B1 replaces lsm_tpu/ops/pallas/gtgram_kernel.py:70 `_energy_kernel` (via
`gtgram_pallas`) together with its XLA phase 1,
lsm_tpu/ops/gammatone.py:345 `gtgram_state_energy`. B3 replaces the
continuous-mode entry gtgram_kernel.py:205 `gtgram_chunk_two_phase`: the
same from a carried (B, 8, C) cascade state, which it returns. Both write
the energies (n_sub, B, C) of every sub-block of g samples.

The TPU ran the cascade in block form, a (g+8, g+8) matrix product per
sub-block on the MXU. On Hopper one templated kernel body runs Slaney's
four-section cascade itself: one thread per (batch row, channel), sample by
sample in exact float32 on the CUDA cores, in the delta-operator form of
the transposed direct form II (25 float32 instructions a sample against the
block form's ~97 at g = 80; its coefficients are `Filterbank.coeffs`). What
bounds it on an H100: float32 instruction throughput and each section's
recurrence latency, hidden by the rows and channels in flight. The carried
state is the block form's TDF2 state, converted in and out once every
`conv_sub` sub-blocks (one 100 ms serving hop by default,
`Filterbank.conv_sub`) and at a call's ends, so chunked calls on hop
boundaries that thread it are bit-equal to one call. No
tensor cores: the state path stays exact float32, without TF32 or bf16.
chip_smoke.py's bound counts Slaney's cascade (17 float32 instructions a
sample).

The plain twins stay the exact block scan of lsm_tpu's `gtgram_iir_scan`,
op for op, on `Filterbank.kmat`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lsm_tpu_torch.ops import _build

N_COEF = 11              # per channel: n0, alpha1, alpha2, beta1[4], beta2[4]

launches = 0             # B1 kernel launches (the plain twin does not count)
chunk_launches = 0       # B3 kernel launches


class Filterbank(NamedTuple):
    """One gammatone filterbank at sub-block length g on one device
    (ops/gammatone.py `filterbank`): the kernels' cascade coefficients
    `coeffs` (C, N_COEF), the plain twins' block system `kmat`
    (C, g+8, g+8), and the kernels' default state-conversion period in
    sub-blocks, `conv_sub` (one 100 ms hop)."""

    coeffs: torch.Tensor
    kmat: torch.Tensor
    conv_sub: int

    @property
    def g(self) -> int:
        return self.kmat.shape[1] - 8


def chunk_plain(wave: torch.Tensor, fb: Filterbank, state: torch.Tensor):
    """Plain PyTorch twin of B3: the exact block scan of lsm_tpu's
    `gtgram_iir_scan`, op for op, from a carried state. wave (B, n_sub*g),
    state (B, 8, C), in fb.kmat's dtype -> (final state (B, 8, C),
    sub-block energies (n_sub, B, C)). Each step's operations do not depend
    on where the signal was cut, so chunked calls that thread the state are
    bit-equal to one call over the whole signal."""
    kmat = fb.kmat
    B, S = wave.shape
    C, Z, _ = kmat.shape
    g = Z - 8
    n_sub = S // g
    blocks = wave.view(B, n_sub, g).transpose(0, 1).contiguous()   # (n_sub, B, g)
    # Flattened per-channel maps, the reference's layouts:
    #   w_yx[l, m*C + c] = M_yx[c, l, m];  w_xs[l, s*C + c] = M_xs[c, l, s]
    w_yx = kmat[:, :g, :g].permute(2, 1, 0).reshape(g, g * C)
    w_xs = kmat[:, g:, :g].permute(2, 1, 0).reshape(g, 8 * C)
    m_sy_t = kmat[:, :g, g:].permute(2, 1, 0).contiguous()      # (8, g, C)
    m_ss_t = kmat[:, g:, g:].permute(2, 1, 0).contiguous()      # (8, 8, C)
    out = torch.empty(n_sub, B, C, dtype=kmat.dtype, device=wave.device)
    for k in range(n_sub):
        x = blocks[k]
        y = (x @ w_yx).view(B, g, C)
        new_state = (x @ w_xs).view(B, 8, C)
        for s in range(8):
            col = state[:, s, :][:, None, :]
            y = y + col * m_sy_t[s][None, :, :]
            new_state = new_state + col * m_ss_t[s][None, :, :]
        out[k] = torch.sum(y * y, dim=1)
        state = new_state
    return state, out


def sub_energy_plain(wave: torch.Tensor, fb: Filterbank) -> torch.Tensor:
    """Plain PyTorch twin of B1: `chunk_plain` from a zero state."""
    state = torch.zeros(wave.shape[0], 8, fb.kmat.shape[0], dtype=fb.kmat.dtype,
                        device=wave.device)
    return chunk_plain(wave, fb, state)[1]


def _check(wave: torch.Tensor, fb: Filterbank, conv_sub: int | None) -> int:
    """Validates the operands; returns the conversion period to launch with."""
    coeffs, kmat = fb.coeffs, fb.kmat
    if not all(t.dtype == torch.float32 for t in (wave, coeffs, kmat)):
        raise TypeError(f"gtgram kernels want float32, got {wave.dtype}, "
                        f"{coeffs.dtype}, {kmat.dtype}")
    C = kmat.shape[0] if kmat.dim() == 3 else -1
    if wave.dim() != 2 or C <= 0 or kmat.shape[1] != kmat.shape[2] or kmat.shape[1] <= 8 \
            or tuple(coeffs.shape) != (C, N_COEF):
        raise ValueError(f"bad shapes wave {tuple(wave.shape)} coeffs {tuple(coeffs.shape)} "
                         f"kmat {tuple(kmat.shape)}")
    if wave.shape[1] % fb.g or wave.shape[1] == 0:
        raise ValueError(f"wave length {wave.shape[1]} is not a positive multiple of "
                         f"g={fb.g}")
    if not wave.device == coeffs.device == kmat.device:
        raise ValueError(f"wave on {wave.device}, operands on {coeffs.device}, {kmat.device}")
    if not all(t.is_contiguous() for t in (wave, coeffs, kmat)):
        raise ValueError("gtgram kernels want contiguous tensors")
    conv_sub = fb.conv_sub if conv_sub is None else conv_sub
    if int(conv_sub) != conv_sub or conv_sub <= 0:
        raise ValueError(f"conversion period {conv_sub} is not a positive number of "
                         "sub-blocks")
    return int(conv_sub)


def _stream(dev: torch.device) -> int:
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return torch.cuda.current_stream(dev).cuda_stream


def sub_energy(wave: torch.Tensor, fb: Filterbank, conv_sub: int | None = None) -> torch.Tensor:
    """Sub-block energies (n_sub, B, C) from a zero state: kernel B1 on
    CUDA, the plain twin on CPU. The kernel converts its state every
    `conv_sub` sub-blocks (default `fb.conv_sub`); the twin has no
    conversion."""
    global launches
    conv_sub = _check(wave, fb, conv_sub)
    if wave.device.type == "cpu":
        return sub_energy_plain(wave, fb)
    B, S = wave.shape
    C, g = fb.coeffs.shape[0], fb.g
    out = torch.empty(S // g, B, C, dtype=torch.float32, device=wave.device)
    fn = _build.function("lsm_gtgram_sub_energy", [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(wave.device):
        err = fn(wave.data_ptr(), fb.coeffs.data_ptr(), out.data_ptr(), B, C, S // g, g,
                 conv_sub, _stream(wave.device))
    _build.check(err, "lsm_gtgram_sub_energy")
    launches += 1
    return out


def chunk(wave: torch.Tensor, fb: Filterbank, state: torch.Tensor,
          conv_sub: int | None = None):
    """(final state (B, 8, C), energies (n_sub, B, C)) of one chunk from the
    carried state: kernel B3 on CUDA, the plain twin on CPU. The kernel
    converts its state every `conv_sub` sub-blocks from the call's start
    (default `fb.conv_sub`) and at the call's end."""
    global chunk_launches
    conv_sub = _check(wave, fb, conv_sub)
    B, S = wave.shape
    C, g = fb.coeffs.shape[0], fb.g
    if state.dtype != torch.float32:
        raise TypeError(f"cascade state must be float32, got {state.dtype}")
    if tuple(state.shape) != (B, 8, C):
        raise ValueError(f"cascade state {tuple(state.shape)} is not ({B}, 8, {C})")
    if state.device != wave.device or not state.is_contiguous():
        raise ValueError(f"cascade state must be contiguous on {wave.device}")
    if wave.device.type == "cpu":
        return chunk_plain(wave, fb, state)
    state_out = torch.empty_like(state)
    out = torch.empty(S // g, B, C, dtype=torch.float32, device=wave.device)
    fn = _build.function("lsm_gtgram_chunk", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(wave.device):
        err = fn(wave.data_ptr(), fb.coeffs.data_ptr(), state.data_ptr(), state_out.data_ptr(),
                 out.data_ptr(), B, C, S // g, g, conv_sub, _stream(wave.device))
    _build.check(err, "lsm_gtgram_chunk")
    chunk_launches += 1
    return state_out, out
