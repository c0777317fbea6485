"""Kernels B5 and B6: the block-sparse LIF reservoir with streaming
statistics (csrc/sparse_lif.cu).

B5 replaces lsm_tpu/ops/pallas/sparse_lif_kernel.py:54 `_sparse_lif_kernel`
(entry `simulate_batch_sparse_pallas`); B6 replaces
lsm_tpu/ops/pallas/sparse_lif_chunk_kernel.py:36 `_sparse_chunk_kernel`
(entry `simulate_chunk_sparse_pallas`), one continuous-mode chunk with v,
refrac and the spike vector carried in and out. Both are one templated
kernel body and compute what B2 and B4 compute (ops/kernels/lif.py), with
the recurrent drive of destination block j summed over its S slots:
drive_j = sum_s s_prev[block src_idx[j, s]] @ w_blocks[j, s].

Like the TPU kernel, which took a tile of up to 256 streams through MXU
products, the CUDA body works on (tile of 64 or 128 streams, destination
block j) per step: for each slot the tile's 0/1 spike plane of the source
block times the 128 x 128 bf16 weight block on the tensor cores (wgmma,
f32 accumulate), plus the step's input bits times W_in[:, block j] as one
more slot. Each weight block is read from L2 once per tile and step, not
once per stream, so the time no longer depends on the firing rate. What
bounds it on an H100: the block products (2 * 128 * 128 * (S + C / 128)
operations a stream-step and block at the bf16 tensor-core peak), the
weight reads from L2, the state read and written each step, and the
latency of each slot's serial chain of load, barrier and products. A tile
is 128 streams when a step still has two CTAs for every SM, else 64.
Every block reads R random partner blocks, so
the C entry point enqueues one launch a step (T a call); v, refrac (8
bits up to refractory 255, 16 above) and two bit-packed spike planes live
between steps in global scratch that the wrapper allocates (`lif.block_scratch`),
and the output statistics are replayed from a bit raster after the last
step.

The plain twins repeat lsm_tpu's `simulate_batch_sparse` and its XLA sparse
chunk scan, with the bf16 weights widened to f32 and multiplied in f32. On
dyadic weights the kernels give the twins' bits; on other weights the
tensor cores sum in another order, which may flip the last bit of a drive.
"""

from __future__ import annotations

import ctypes

import torch

from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.ops.kernels.lif import (
    MAX_REFRACTORY, SEG_KEYS, STAT_KEYS, block_scratch, chunk_scan, stats_scan)

BLOCK = 128

_STATS = _build.Entry("lsm_sparse_lif_stats", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)                  # B5
_CHUNK = _build.Entry("lsm_sparse_lif_chunk", [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)                  # B6


def sparse_drive(s_prev: torch.Tensor, w_blocks: torch.Tensor,
                 src_idx: torch.Tensor) -> torch.Tensor:
    """Block-sparse recurrent drive (lsm_tpu's `sparse_drive`): for each
    destination block j, sum_s s_prev[:, block src_idx[j, s]] @ w_blocks[j, s]
    as one gather and one batched matmul. s_prev (B, N), w_blocks
    (nb, S, 128, 128) in the product's dtype, src_idx (nb, S) int64.
    Returns (B, N) in that dtype."""
    B = s_prev.shape[0]
    nb, S = src_idx.shape
    g = s_prev.reshape(B, -1, BLOCK)[:, src_idx.reshape(-1)]     # (B, nb*S, 128)
    g = g.reshape(B, nb, S * BLOCK).transpose(0, 1)              # (nb, B, S*128)
    out = torch.bmm(g, w_blocks.reshape(nb, S * BLOCK, BLOCK))   # (nb, B, 128)
    return out.transpose(0, 1).reshape(B, nb * BLOCK)


def _recurrent(w_blocks, src_idx):
    wb = w_blocks.to(torch.float32)
    idx = src_idx.to(torch.int64)
    return lambda s: sparse_drive(s, wb, idx)


def sparse_lif_stats_plain(x, w_blocks, src_idx, w_in, leak_keep, **kw):
    """Plain twin of B5: lsm_tpu's `simulate_batch_sparse(matmul_dtype=bf16)`.
    Returns (stats (11, B, no) f32 in STAT_KEYS order, all_counts (B, N))."""
    return stats_scan(x, _recurrent(w_blocks, src_idx), w_in, leak_keep, **kw)


def sparse_lif_chunk_plain(x, w_blocks, src_idx, w_in, leak_keep, v, refrac, s_prev, **kw):
    """Plain twin of B6: lsm_tpu's XLA sparse chunk scan
    (lsm_tpu/models/continuous.py:514-558). Returns (v, refrac, s_prev,
    seg (9, B, no) in SEG_KEYS order, win (B, n_new_win, no))."""
    return chunk_scan(x, _recurrent(w_blocks, src_idx), w_in, leak_keep, v, refrac,
                      s_prev, **kw)


def _check(x, w_blocks, src_idx, w_in, leak_keep, n_outputs):
    if x.dtype != torch.uint8:
        raise TypeError(f"spikes must be uint8, got {x.dtype}")
    if w_blocks.dtype != torch.bfloat16 or w_in.dtype != torch.bfloat16:
        raise TypeError(f"weights must be bfloat16, got {w_blocks.dtype}, {w_in.dtype}")
    if src_idx.dtype != torch.int32:
        raise TypeError(f"src_idx must be int32, got {src_idx.dtype}")
    if leak_keep.dtype != torch.float32:
        raise TypeError(f"leak_keep must be float32, got {leak_keep.dtype}")
    if x.dim() != 3:
        raise ValueError(f"spikes must be (B, C, T), got {tuple(x.shape)}")
    nb, S = src_idx.shape if src_idx.dim() == 2 else (0, 0)
    n = nb * BLOCK
    if nb == 0 or tuple(w_blocks.shape) != (nb, S, BLOCK, BLOCK) or w_in.dim() != 2 \
            or w_in.shape[1] != n or tuple(leak_keep.shape) != (n,):
        raise ValueError(
            f"bad block-sparse shapes w_blocks {tuple(w_blocks.shape)} src_idx "
            f"{tuple(src_idx.shape)} w_in {tuple(w_in.shape)} leak_keep "
            f"{tuple(leak_keep.shape)}"
        )
    if x.shape[1] > w_in.shape[0] or not 0 < n_outputs <= n:
        raise ValueError(f"{x.shape[1]} channels / {n_outputs} outputs do not fit")
    devs = {t.device for t in (x, w_blocks, src_idx, w_in, leak_keep)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in (x, w_blocks, src_idx, w_in, leak_keep)):
        raise ValueError("the sparse LIF kernels want contiguous tensors")


def _check_cuda(name, x, refractory):
    """The block body's own limits, before any launch: T > 0 and a
    refractory counter of at most 16 bits."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    T = x.shape[2]
    if T == 0 or not 0 <= refractory <= MAX_REFRACTORY:
        raise ValueError(
            f"kernel {name} takes T > 0 and 0 <= refractory <= {MAX_REFRACTORY} (refrac is "
            f"kept in at most 16 bits between steps); got T={T} refractory={refractory}"
        )


def sparse_lif_stats(x, w_blocks, src_idx, w_in, leak_keep, *, threshold, refractory,
                     burst_isi_max, n_outputs, n_win):
    """(stats (11, B, no), all_counts (B, N)): kernel B5 on CUDA, the plain
    twin on CPU."""
    _check(x, w_blocks, src_idx, w_in, leak_keep, n_outputs)
    kw = dict(threshold=threshold, refractory=refractory,
              burst_isi_max=burst_isi_max, n_outputs=n_outputs, n_win=n_win)
    if x.device.type == "cpu":
        return sparse_lif_stats_plain(x, w_blocks, src_idx, w_in, leak_keep, **kw)
    _check_cuda("B5", x, refractory)
    B, C, T = x.shape
    nb, S = src_idx.shape
    dev = x.device
    stats = torch.empty(len(STAT_KEYS), B, n_outputs, dtype=torch.float32, device=dev)
    all_counts = torch.empty(B, nb * BLOCK, dtype=torch.float32, device=dev)
    scratch = block_scratch(x, nb * BLOCK, S, n_outputs, False, refractory)
    _STATS.launch(dev, x.data_ptr(), w_blocks.data_ptr(), src_idx.data_ptr(), w_in.data_ptr(),
                  leak_keep.data_ptr(), stats.data_ptr(), all_counts.data_ptr(),
                  B, C, T, nb * BLOCK, S, n_outputs, float(threshold), int(refractory),
                  int(burst_isi_max), max(1, T // n_win), int(n_win), scratch.data_ptr())
    return stats, all_counts


def sparse_lif_chunk(x, w_blocks, src_idx, w_in, leak_keep, v, refrac, s_prev, *,
                     threshold, refractory, burst_isi_max, n_outputs, win_len, n_new_win):
    """One carried-state chunk: (v, refrac, s_prev, seg (9, B, no),
    win (B, n_new_win, no)). Kernel B6 on CUDA, the plain twin on CPU."""
    _check(x, w_blocks, src_idx, w_in, leak_keep, n_outputs)
    B, C, T = x.shape
    nb, S = src_idx.shape
    n = nb * BLOCK
    for name, t, dt in (("v", v, torch.float32), ("refrac", refrac, torch.int32),
                        ("s_prev", s_prev, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != (B, n) or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous ({B}, {n}) tensor on {x.device}, "
                f"got {tuple(t.shape)} on {t.device}"
            )
    if win_len <= 0 or n_new_win <= 0 or T != win_len * n_new_win:
        raise ValueError(f"chunk of {T} steps is not {n_new_win} windows of {win_len}")
    kw = dict(threshold=threshold, refractory=refractory, burst_isi_max=burst_isi_max,
              n_outputs=n_outputs, win_len=win_len, n_new_win=n_new_win)
    if x.device.type == "cpu":
        return sparse_lif_chunk_plain(x, w_blocks, src_idx, w_in, leak_keep, v, refrac,
                                      s_prev, **kw)
    _check_cuda("B6", x, refractory)
    dev = x.device
    v_out = torch.empty_like(v)
    refrac_out = torch.empty_like(refrac)
    s_out = torch.empty_like(s_prev)
    seg = torch.empty(len(SEG_KEYS), B, n_outputs, dtype=torch.float32, device=dev)
    win = torch.empty(B, n_new_win, n_outputs, dtype=torch.float32, device=dev)
    scratch = block_scratch(x, n, S, n_outputs, True, refractory)
    _CHUNK.launch(dev, x.data_ptr(), w_blocks.data_ptr(), src_idx.data_ptr(), w_in.data_ptr(),
                  leak_keep.data_ptr(), v.data_ptr(), refrac.data_ptr(), s_prev.data_ptr(),
                  v_out.data_ptr(), refrac_out.data_ptr(), s_out.data_ptr(),
                  seg.data_ptr(), win.data_ptr(),
                  B, C, T, n, S, n_outputs, float(threshold), int(refractory),
                  int(burst_isi_max), int(win_len), int(n_new_win), scratch.data_ptr())
    return v_out, refrac_out, s_out, seg, win
