"""Kernels B2 and B4: fused dense LIF reservoir with streaming statistics
(csrc/lif.cu).

B2 replaces lsm_tpu/ops/pallas/lif_kernel.py:46 `_lif_kernel` (entry
`simulate_batch_pallas`); B4 replaces lsm_tpu/ops/pallas/lif_chunk_kernel.py:39
`_lif_chunk_kernel` (entry `simulate_chunk_pallas`), one continuous-mode
chunk with v, refrac and the spike vector carried in and out, a segment
summary with segment-relative times and per-window counts, and no
all_counts. Both are one templated kernel body. The TPU kept W_rec (2 MB
bf16) resident in VMEM; a Hopper SM has 227 KB of shared memory, so the
kernel streams W from the 50 MB L2 instead: one CTA per batch row, one thread per neuron, the state
and statistics in registers, and each step reads only the W rows of the
neurons and input channels that fired (spikes are 0/1). What bounds it on
an H100: the L2 latency of those row reads and two block barriers per
step, not FLOPs (the TPU formulation's dense (B, N) x (N, N) matmul does
~50x more work at a ~2 % firing rate). B4 compacts the carried spike
vector before its first step, so that step's recurrent drive comes from
the previous chunk's last spikes. Above 1024 padded neurons (up to 4096,
the largest dense reservoir the port draws) the C entry points run the
stream-tiled block body of csrc/sparse_lif.cu instead, with the dense
matrix seen as N_pad/128 x N_pad/128 blocks, in global scratch that the
wrapper allocates (`block_scratch`); that body keeps refrac in 8 bits
(refractory <= 255).
"""

from __future__ import annotations

import ctypes

import torch

from lsm_tpu_torch.ops import _build

STAT_KEYS = (
    "counts", "sum_t", "sum_t2", "first", "last", "n_isi", "sum_isi",
    "sum_isi2", "bursts", "win_sum", "win_sum2",
)
SEG_KEYS = STAT_KEYS[:9]  # the segment summary B4 writes
MAX_NEURONS = 4096       # N_pad <= 1024: one thread a neuron; above: the block body
_ONE_THREAD_MAX = 1024
MAX_REFRACTORY = 255     # the block body's 8-bit refractory counter

launches = 0             # B2 kernel launches (the plain twin does not count)
chunk_launches = 0       # B4 kernel launches


def _lif_update(v, refrac, drive, leak_keep, threshold, refractory):
    """One LIF step (lsm_tpu's `lif_update`): leak + integrate while not
    refractory, threshold, reset, refractory countdown. The product and
    the sum round separately, as the kernels' __fmul_rn/__fadd_rn do.
    Returns (v, refrac int32, spike bool)."""
    active = refrac == 0
    v_new = torch.where(active, v * leak_keep + drive, 0.0)
    spike = (v_new >= threshold) & active
    refrac = torch.where(spike, refractory, torch.clamp(refrac - 1, min=0)).to(torch.int32)
    return torch.where(spike, 0.0, v_new), refrac, spike


def lif_stats_plain(
    x: torch.Tensor,            # (B, C, T) uint8 0/1
    w_rec: torch.Tensor,        # (Np, Np) bfloat16, row = source
    w_in: torch.Tensor,         # (Cp, Np) bfloat16
    leak_keep: torch.Tensor,    # (Np,) float32 = 1 - leak
    **kw,
):
    """Plain PyTorch twin: lsm_tpu's `simulate_batch(matmul_dtype=bf16)`.
    The bf16 weights are widened to f32 and multiplied in f32, which is what
    bf16 operands with f32 accumulation compute (a bf16 torch.matmul would
    round its OUTPUT to bf16). Returns (stats (11, B, no) f32 in STAT_KEYS
    order, all_counts (B, Np) f32)."""
    wr = w_rec.to(torch.float32)
    return stats_scan(x, lambda s: s @ wr, w_in, leak_keep, **kw)


def stats_scan(x, recurrent, w_in, leak_keep, *, threshold, refractory,
               burst_isi_max, n_outputs, n_win):
    """The twins' batch scan from a zero state: per step the drive
    recurrent(s_prev) + x_t @ f32(w_in), the LIF update, and the output
    neurons' streaming statistics (the first n_win-1 windows are win_len
    steps, later steps fold into the last). `recurrent` maps the (B, N) f32
    spike vector to its (B, N) f32 drive."""
    B, C, T = x.shape
    n_state = leak_keep.shape[0]
    c_pad = w_in.shape[0]
    no = n_outputs
    win_len = max(1, T // n_win)
    dev = x.device
    wi = w_in.to(torch.float32)
    xf = torch.zeros(B, c_pad, T, dtype=torch.float32, device=dev)
    xf[:, :C] = x.to(torch.float32)

    def zeros(width):
        return torch.zeros(B, width, dtype=torch.float32, device=dev)

    v, s, all_counts = zeros(n_state), zeros(n_state), zeros(n_state)
    refrac = torch.zeros(B, n_state, dtype=torch.int32, device=dev)
    st = {k: zeros(no) for k in STAT_KEYS}
    st["first"].fill_(float("inf"))
    st["last"].fill_(-1.0)
    prev_t = torch.full((B, no), -1.0, device=dev)
    c_cur = zeros(no)
    for t in range(T):
        v, refrac, spike = _lif_update(v, refrac, recurrent(s) + xf[:, :, t] @ wi,
                                       leak_keep, threshold, refractory)
        s = spike.to(torch.float32)
        all_counts += s

        sb = spike[:, :no]
        so = s[:, :no]
        tf = float(t)
        st["counts"] += so
        st["sum_t"] += so * tf
        st["sum_t2"] += so * tf * tf
        st["first"] = torch.minimum(st["first"], torch.where(sb, tf, float("inf")))
        st["last"] = torch.maximum(st["last"], torch.where(sb, tf, -1.0))
        isi = tf - prev_t
        isi_event = sb & (prev_t >= 0.0)
        isi_f = torch.where(isi_event, isi, 0.0)
        st["n_isi"] += isi_event.to(torch.float32)
        st["sum_isi"] += isi_f
        st["sum_isi2"] += isi_f * isi_f
        st["bursts"] += (isi_event & (isi <= burst_isi_max)).to(torch.float32)
        prev_t = torch.where(sb, tf, prev_t)
        c_cur += so
        # The first n_win-1 windows are win_len steps; later steps fold
        # into the last window.
        if ((t + 1) % win_len == 0 and (t + 1) // win_len < n_win) or t == T - 1:
            st["win_sum"] += c_cur
            st["win_sum2"] += c_cur * c_cur
            c_cur = zeros(no)
    return torch.stack([st[k] for k in STAT_KEYS]), all_counts


def _check(x, w_rec, w_in, leak_keep, n_outputs):
    if x.dtype != torch.uint8:
        raise TypeError(f"spikes must be uint8, got {x.dtype}")
    if w_rec.dtype != torch.bfloat16 or w_in.dtype != torch.bfloat16:
        raise TypeError(f"weights must be bfloat16, got {w_rec.dtype}, {w_in.dtype}")
    if leak_keep.dtype != torch.float32:
        raise TypeError(f"leak_keep must be float32, got {leak_keep.dtype}")
    if x.dim() != 3:
        raise ValueError(f"spikes must be (B, C, T), got {tuple(x.shape)}")
    n_pad = w_rec.shape[0]
    if w_rec.shape != (n_pad, n_pad) or w_in.dim() != 2 or w_in.shape[1] != n_pad \
            or leak_keep.shape != (n_pad,):
        raise ValueError(
            f"bad weight shapes w_rec {tuple(w_rec.shape)} w_in "
            f"{tuple(w_in.shape)} leak_keep {tuple(leak_keep.shape)}"
        )
    if x.shape[1] > w_in.shape[0] or not 0 < n_outputs <= n_pad:
        raise ValueError(f"{x.shape[1]} channels / {n_outputs} outputs do not fit")
    devs = {t.device for t in (x, w_rec, w_in, leak_keep)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in (x, w_rec, w_in, leak_keep)):
        raise ValueError("lif_stats wants contiguous tensors")


def _check_cuda(name, x, n_pad, refractory):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, C, T = x.shape
    if n_pad > MAX_NEURONS or n_pad % 32 or C > n_pad or T == 0:
        raise ValueError(
            f"kernel {name} takes T > 0, N_pad <= {MAX_NEURONS}, N_pad % 32 == 0 "
            f"and C <= N_pad; got T={T} N_pad={n_pad} C={C}"
        )
    if n_pad > _ONE_THREAD_MAX and (n_pad % 128 or not 0 <= refractory <= MAX_REFRACTORY):
        raise ValueError(
            f"kernel {name} above {_ONE_THREAD_MAX} padded neurons takes N_pad % 128 == 0 "
            f"and 0 <= refractory <= {MAX_REFRACTORY}; got N_pad={n_pad} "
            f"refractory={refractory}"
        )


def block_scratch(x, n_state, n_slots, n_outputs, chunk):
    """The global scratch (uint8) of one call of the stream-tiled block
    body (csrc/sparse_lif.cu) on spikes x (B, C, T) at n_state neurons and
    n_slots source blocks a destination block: the K-major weight blocks,
    spike bit planes, input bits, output raster, 8-bit refrac and, for the
    batch kernels, v."""
    B, C, T = x.shape
    fn = _build.function("lsm_block_lif_scratch_bytes", [ctypes.c_int] * 7)
    fn.restype = ctypes.c_longlong
    n_bytes = fn(B, C, T, n_state, n_slots, n_outputs, int(chunk))
    return torch.empty(n_bytes, dtype=torch.uint8, device=x.device)


def _scratch_ptr(x, n_pad, n_outputs, chunk):
    """(tensor kept alive for the call, pointer): the block body's scratch
    above one thread a neuron (the dense matrix as n_pad / 128 slots), none
    below."""
    if n_pad <= _ONE_THREAD_MAX:
        return None, None
    sc = block_scratch(x, n_pad, n_pad // 128, n_outputs, chunk)
    return sc, sc.data_ptr()


def lif_stats(x, w_rec, w_in, leak_keep, *, threshold, refractory,
              burst_isi_max, n_outputs, n_win):
    """(stats (11, B, no), all_counts (B, Np)): kernel B2 on CUDA, the plain
    twin on CPU."""
    global launches
    _check(x, w_rec, w_in, leak_keep, n_outputs)
    kw = dict(threshold=threshold, refractory=refractory,
              burst_isi_max=burst_isi_max, n_outputs=n_outputs, n_win=n_win)
    if x.device.type == "cpu":
        return lif_stats_plain(x, w_rec, w_in, leak_keep, **kw)
    n_pad = w_rec.shape[0]
    _check_cuda("B2", x, n_pad, refractory)
    B, C, T = x.shape
    stats = torch.empty(len(STAT_KEYS), B, n_outputs, dtype=torch.float32, device=x.device)
    all_counts = torch.empty(B, n_pad, dtype=torch.float32, device=x.device)
    fn = _build.function("lsm_lif_stats", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ])
    with torch.cuda.device(x.device):
        _keep, scratch = _scratch_ptr(x, n_pad, n_outputs, chunk=False)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w_rec.data_ptr(), w_in.data_ptr(),
                 leak_keep.data_ptr(), stats.data_ptr(), all_counts.data_ptr(),
                 B, C, T, n_pad, n_outputs, float(threshold), int(refractory),
                 int(burst_isi_max), max(1, T // n_win), int(n_win), scratch, stream)
    _build.check(err, "lsm_lif_stats")
    launches += 1
    return stats, all_counts


def lif_chunk_plain(x, w_rec, w_in, leak_keep, v, refrac, s_prev, **kw):
    """Plain PyTorch twin of B4: lsm_tpu's XLA chunk path
    (tests/test_continuous.py:168-192). Weights widened from bf16 to f32 as
    in `lif_stats_plain`. Returns (v, refrac, s_prev, seg (9, B, no) in
    SEG_KEYS order, win (B, n_new_win, no))."""
    wr = w_rec.to(torch.float32)
    return chunk_scan(x, lambda s: s @ wr, w_in, leak_keep, v, refrac, s_prev, **kw)


def chunk_scan(x, recurrent, w_in, leak_keep, v, refrac, s_prev, *, threshold,
               refractory, burst_isi_max, n_outputs, win_len, n_new_win):
    """The twins' chunk scan: `lif_update` from the carried (v, refrac,
    s_prev) with the drive recurrent(s_prev) + x_t @ f32(w_in), then
    `segment_summary` of the output raster and the rate-window
    reshape-sum."""
    # models/reservoir.py imports this module; its summary is the oracle.
    from lsm_tpu_torch.models.reservoir import segment_summary

    B, C, T = x.shape
    no = n_outputs
    wi = w_in.to(torch.float32)
    xf = torch.zeros(B, w_in.shape[0], T, dtype=torch.float32, device=x.device)
    xf[:, :C] = x.to(torch.float32)
    raster = torch.empty(B, T, no, dtype=torch.bool, device=x.device)
    s = s_prev
    for t in range(T):
        v, refrac, spike = _lif_update(v, refrac, recurrent(s) + xf[:, :, t] @ wi,
                                       leak_keep, threshold, refractory)
        s = spike.to(torch.float32)
        raster[:, t] = spike[:, :no]
    seg = segment_summary(raster, burst_isi_max)
    win = raster.to(torch.float32).view(B, n_new_win, win_len, no).sum(dim=2)
    return v, refrac, s, torch.stack([seg[k] for k in SEG_KEYS]), win


def lif_chunk(x, w_rec, w_in, leak_keep, v, refrac, s_prev, *, threshold,
              refractory, burst_isi_max, n_outputs, win_len, n_new_win):
    """One carried-state chunk: (v, refrac, s_prev, seg (9, B, no),
    win (B, n_new_win, no)). Kernel B4 on CUDA, the plain twin on CPU."""
    global chunk_launches
    _check(x, w_rec, w_in, leak_keep, n_outputs)
    B, C, T = x.shape
    n_pad = w_rec.shape[0]
    for name, t, dt in (("v", v, torch.float32), ("refrac", refrac, torch.int32),
                        ("s_prev", s_prev, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != (B, n_pad) or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous ({B}, {n_pad}) tensor on {x.device}, "
                f"got {tuple(t.shape)} on {t.device}"
            )
    if win_len <= 0 or n_new_win <= 0 or T != win_len * n_new_win:
        raise ValueError(f"chunk of {T} steps is not {n_new_win} windows of {win_len}")
    kw = dict(threshold=threshold, refractory=refractory, burst_isi_max=burst_isi_max,
              n_outputs=n_outputs, win_len=win_len, n_new_win=n_new_win)
    if x.device.type == "cpu":
        return lif_chunk_plain(x, w_rec, w_in, leak_keep, v, refrac, s_prev, **kw)
    _check_cuda("B4", x, n_pad, refractory)
    dev = x.device
    v_out = torch.empty_like(v)
    refrac_out = torch.empty_like(refrac)
    s_out = torch.empty_like(s_prev)
    seg = torch.empty(len(SEG_KEYS), B, n_outputs, dtype=torch.float32, device=dev)
    win = torch.empty(B, n_new_win, n_outputs, dtype=torch.float32, device=dev)
    fn = _build.function("lsm_lif_chunk", [ctypes.c_void_p] * 12 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ])
    with torch.cuda.device(dev):
        _keep, scratch = _scratch_ptr(x, n_pad, n_outputs, chunk=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), w_rec.data_ptr(), w_in.data_ptr(), leak_keep.data_ptr(),
                 v.data_ptr(), refrac.data_ptr(), s_prev.data_ptr(),
                 v_out.data_ptr(), refrac_out.data_ptr(), s_out.data_ptr(),
                 seg.data_ptr(), win.data_ptr(),
                 B, C, T, n_pad, n_outputs, float(threshold), int(refractory),
                 int(burst_isi_max), int(win_len), int(n_new_win), scratch, stream)
    _build.check(err, "lsm_lif_chunk")
    chunk_launches += 1
    return v_out, refrac_out, s_out, seg, win
