"""Kernels B1 and B3: gammatone sub-block energies (csrc/gtgram.cu).

B1 replaces lsm_tpu/ops/pallas/gtgram_kernel.py:70 `_energy_kernel` (via
`gtgram_pallas`) together with its XLA phase 1,
lsm_tpu/ops/gammatone.py:345 `gtgram_state_energy`. B3 replaces the
continuous-mode entry gtgram_kernel.py:205 `gtgram_chunk_two_phase`: the
same two phases from a carried (B, 8, C) cascade state, which it returns.
The TPU split the work into two phases only to avoid a Mosaic relayout; on
Hopper one kernel body (templated on the carried state) runs the exact
block recurrence: one thread per (batch row, channel) carries the 8-dim
cascade state in registers, the channel's (g+8, g+8) block system (~31 KB
at g=80) sits in shared memory, and each sub-block costs (g+8)^2 float32
FMAs.

What bounds both on an H100: float32 FMA throughput on the CUDA cores (no
tensor cores: the state path must stay exact f32, so no TF32 and no bf16)
and the shared-memory operand reads that feed them (one 16-byte broadcast
load per four FMAs). The waveform is re-read once per channel; CTAs of one
batch tile over all channels are scheduled together, so those re-reads hit
L2. B1 at 2400 utterances does ~0.95 TFLOP of FMAs; B3 at 1024 streams
does ~40.6 GFLOP a 100 ms hop. The function itself, Slaney's sequential
cascade, needs ~5.8x less (17 float32 instructions a sample), and
chip_smoke.py's bound counts that.
"""

from __future__ import annotations

import ctypes

import torch

from lsm_tpu_torch.ops import _build

G = 80                   # samples per sub-block the kernels are compiled for
_BT = 64                 # batch rows per CTA (csrc/gtgram.cu)

launches = 0             # B1 kernel launches (the plain twin does not count)
chunk_launches = 0       # B3 kernel launches


def chunk_plain(wave: torch.Tensor, kmat: torch.Tensor, state: torch.Tensor):
    """Plain PyTorch twin of B3: the exact block scan of lsm_tpu's
    `gtgram_iir_scan`, op for op, from a carried state. wave (B, n_sub*g)
    f32, kmat (C, g+8, g+8) f32, state (B, 8, C) f32 -> (final state
    (B, 8, C), sub-block energies (n_sub, B, C)). Each step's operations
    do not depend on where the signal was cut, so chunked calls that
    thread the state are bit-equal to one call over the whole signal."""
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
    out = torch.empty(n_sub, B, C, dtype=torch.float32, device=wave.device)
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


def sub_energy_plain(wave: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of B1: `chunk_plain` from a zero state, energies
    in B1's (n_sub, C, B) layout."""
    B = wave.shape[0]
    state = torch.zeros(B, 8, kmat.shape[0], dtype=torch.float32, device=wave.device)
    return chunk_plain(wave, kmat, state)[1].permute(0, 2, 1).contiguous()


def _check(wave: torch.Tensor, kmat: torch.Tensor) -> None:
    if wave.dtype != torch.float32 or kmat.dtype != torch.float32:
        raise TypeError(f"gtgram kernels want float32, got {wave.dtype}, {kmat.dtype}")
    if wave.dim() != 2 or kmat.dim() != 3 or kmat.shape[1] != kmat.shape[2]:
        raise ValueError(f"bad shapes wave {tuple(wave.shape)} kmat {tuple(kmat.shape)}")
    g = kmat.shape[1] - 8
    if wave.shape[1] % g:
        raise ValueError(f"wave length {wave.shape[1]} is not a multiple of g={g}")
    if wave.device != kmat.device:
        raise ValueError(f"wave on {wave.device}, kmat on {kmat.device}")
    if not (wave.is_contiguous() and kmat.is_contiguous()):
        raise ValueError("gtgram kernels want contiguous tensors")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """What the compiled kernels need beyond `_check`: a CUDA device, g=80,
    16-byte aligned operands (float4 loads)."""
    wave, kmat = tensors[:2]
    if wave.device.type != "cuda":
        raise ValueError(f"unsupported device {wave.device}")
    g = kmat.shape[1] - 8
    if g != G:
        raise ValueError(f"kernel {name} is compiled for g={G}, got g={g}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"kernel {name} loads float4: tensors must be 16-byte aligned")


def sub_energy(wave: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    """Sub-block energies (n_sub, C, B) from a zero state: kernel B1 on
    CUDA, the plain twin on CPU."""
    global launches
    _check(wave, kmat)
    if wave.device.type == "cpu":
        return sub_energy_plain(wave, kmat)
    _check_cuda("B1", wave, kmat)
    B, S = wave.shape
    C = kmat.shape[0]
    n_sub = S // G
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


def chunk(wave: torch.Tensor, kmat: torch.Tensor, state: torch.Tensor):
    """(final state (B, 8, C), energies (n_sub, B, C)) of one chunk from the
    carried state: kernel B3 on CUDA, the plain twin on CPU."""
    global chunk_launches
    _check(wave, kmat)
    B = wave.shape[0]
    C = kmat.shape[0]
    if state.dtype != torch.float32:
        raise TypeError(f"cascade state must be float32, got {state.dtype}")
    if tuple(state.shape) != (B, 8, C):
        raise ValueError(f"cascade state {tuple(state.shape)} is not ({B}, 8, {C})")
    if state.device != wave.device or not state.is_contiguous():
        raise ValueError(f"cascade state must be contiguous on {wave.device}")
    if wave.device.type == "cpu":
        return chunk_plain(wave, kmat, state)
    _check_cuda("B3", wave, kmat, state)
    n_sub = wave.shape[1] // G
    if n_sub == 0:
        raise ValueError("kernel B3 needs at least one sub-block")
    state_out = torch.empty_like(state)
    out = torch.empty(n_sub, B, C, dtype=torch.float32, device=wave.device)
    fn = _build.function("lsm_gtgram_chunk", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream(wave.device).cuda_stream
        err = fn(wave.data_ptr(), kmat.data_ptr(), state.data_ptr(),
                 state_out.data_ptr(), out.data_ptr(), B, C, n_sub, stream)
    _build.check(err, "lsm_gtgram_chunk")
    chunk_launches += 1
    return state_out, out
