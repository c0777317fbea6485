"""Kernels B2 and B4: fused dense LIF reservoir with streaming statistics
(csrc/lif.cu).

B2 replaces lsm_tpu/ops/pallas/lif_kernel.py:46 `_lif_kernel` (entry
`simulate_batch_pallas`); B4 replaces lsm_tpu/ops/pallas/lif_chunk_kernel.py:39
`_lif_chunk_kernel` (entry `simulate_chunk_pallas`), one continuous-mode
chunk with v, refrac and the spike vector carried in and out, a segment
summary with segment-relative times and per-window counts, and no
all_counts. Spikes are 0/1, so each step's drive is the sum of the W rows
of the sources that fired, in ascending source order (recurrent rows, then
input rows, into two f32 accumulators): every body gives the same bits on
any weights, and the plain twin's on dyadic ones.

`dense_plan` picks the body of a call and its tiling, in this one place;
the C entry points check the plan and run it:

- the cluster body (N_pad = 64 K, K = 2..16): the TPU kept W_rec (2 MB
  bf16) resident in VMEM; here a thread-block cluster of K CTAs keeps it
  resident in shared memory, 64 destination columns a CTA (128 KB at
  N_pad 1024, plus W_in's 128 bytes a channel). A cluster takes M streams
  a round, one warp a stream, two neurons a lane; a step compacts the
  stream's input and spike bit words into lists of source indices and
  adds one shared-memory row per source, runs the LIF update and
  statistics in registers, and sends its spike words to every CTA of the
  cluster with st.async, counted there by an mbarrier (no cluster-wide
  barrier a step; one ends each round). What bounds it is instruction
  issue (~10 a fired row, warp and CTA) and a step's latency, not bytes or
  FLOPs. Budget: at most
  232,448 bytes of shared memory and 24 streams (768 threads, one CTA an
  SM, up to 80 registers a thread, so the state and OutputStats of two
  neurons stay in registers);
- the one-thread body, one CTA a stream, one thread a neuron, the fired
  sources compacted into lists each step (two block barriers a step): the
  shapes whose slices do not fit a cluster (C = 2048 channels at
  redundancy 16 is 256 KB of W_in a CTA) or whose N_pad is not a multiple
  of 64 of at least 128. It takes any number of input channels (thread n
  compacts channels n, n + N_pad, ...);
- the block body above 1024 padded neurons: the stream-tiled body of
  csrc/sparse_lif.cu with the dense matrix seen as N_pad/128 x N_pad/128
  blocks, in global scratch that the wrapper allocates (`block_scratch`);
  it keeps refrac in 8 bits up to refractory 255 and in 16 bits above
  (refractory <= 65535). It has no size limit of its own: what it cannot
  take is scratch past the card's free memory (the K-major weight blocks
  alone are N_pad^2 x 2 bytes, 210 MB at 10240 neurons), where the
  allocator's OutOfMemoryError comes back saying what the scratch holds
  (`alloc_block_scratch`). A dense call walks all N_pad/128 source blocks
  every step, so at 10240 neurons it reads 80 blocks a destination block
  a step.

A CUDA tensor always launches the body its plan names, or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from lsm_tpu_torch.ops import _build

STAT_KEYS = (
    "counts", "sum_t", "sum_t2", "first", "last", "n_isi", "sum_isi",
    "sum_isi2", "bursts", "win_sum", "win_sum2",
)
SEG_KEYS = STAT_KEYS[:9]  # the segment summary B4 writes
_ONE_THREAD_MAX = 1024   # N_pad <= 1024: the cluster or one-thread body; above: the block body
MAX_REFRACTORY = 65535   # the block body's refractory counter: 8 bits, 16 above 255
# The cluster body (csrc/lif.cu, which refuses a plan past these): 64
# destination neurons a CTA, at most 16 CTAs a cluster and 24 streams
# (warps) a round, within an SM's 232,448 bytes of shared memory.
CLUSTER_SLICE, MAX_CLUSTER, MAX_CLUSTER_STREAMS = 64, 16, 24
SMEM_LIMIT = 232_448
ONE_THREAD, CLUSTER, BLOCK = "one_thread", "cluster", "block"
_BODY_CODE = {ONE_THREAD: 0, CLUSTER: 1, BLOCK: 2}     # as csrc/lif.cu numbers them

# B2 and B4 count in _build.launches by entry point and by body
# ('lsm_lif_stats:cluster', ...).
_STATS = _build.Entry("lsm_lif_stats", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_float] + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2)                  # B2
_CHUNK = _build.Entry("lsm_lif_chunk", [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
    ctypes.c_float] + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2)                  # B4
_CLUSTER_SMEM = _build.Entry("lsm_lif_cluster_smem", [ctypes.c_int] * 3, ctypes.c_longlong)
_CLUSTER_CAPACITY = _build.Entry("lsm_lif_cluster_capacity",
                                 [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
_SCRATCH_BYTES = _build.Entry("lsm_block_lif_scratch_bytes", [ctypes.c_int] * 8,
                              ctypes.c_longlong)


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
               burst_isi_max, n_outputs, n_win, gather=None):
    """The twins' batch scan from a zero state: per step the drive
    recurrent(s_prev) + x_t @ f32(w_in), the LIF update, and the output
    neurons' streaming statistics (the first n_win-1 windows are win_len
    steps, later steps fold into the last). `recurrent` maps the (B, N) f32
    spike vector to its (B, N) f32 drive.

    The tensor-parallel reservoir (parallel/sharded.py) runs the same scan
    over its slice of the neurons: w_in and leak_keep hold the slice's
    columns, `gather` assembles the full (B, N) spike vector from the
    slice's each step, `recurrent` maps it to the slice's drive, and the
    statistics accumulate on the gathered output neurons. all_counts is
    then the slice's."""
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

    gather = gather or (lambda s_local: s_local)
    v, all_counts = zeros(n_state), zeros(n_state)
    s = gather(zeros(n_state))
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
        s = gather(s)

        so = s[:, :no]
        sb = so > 0.0
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


def _check_cuda(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.shape[2] == 0:
        raise ValueError(f"kernel {name} takes T > 0")


@dataclass(frozen=True)
class DensePlan:
    """How one dense B2/B4 call runs: its body and, for the cluster body,
    K CTAs a cluster (`cluster_size`, K x 64 = N_pad), M streams a round
    (`streams`, one warp each: `threads` = 32 M), its bytes of dynamic
    shared memory, the clusters launched, the rounds the busiest cluster
    walks, and the clusters the card holds at once (`co_resident`)."""

    body: str
    cluster_size: int = 0
    streams: int = 0
    threads: int = 0
    smem_bytes: int = 0
    clusters: int = 0
    rounds: int = 0
    co_resident: int = 0

    def c_args(self) -> tuple:
        """The six ints the C entry points take: body, K, M, threads,
        shared-memory bytes, clusters."""
        return (_BODY_CODE[self.body], self.cluster_size, self.streams, self.threads,
                self.smem_bytes, self.clusters)


def max_cluster_streams(n_pad: int, channels: int,
                        smem_bytes: Callable[[int, int, int], int]) -> int:
    """The most streams a cluster round takes (<= 24) with the slices in
    shared memory, or 0 where the cluster body does not take the shape."""
    if n_pad % CLUSTER_SLICE or not 2 <= n_pad // CLUSTER_SLICE <= MAX_CLUSTER:
        return 0
    return max((m for m in range(1, MAX_CLUSTER_STREAMS + 1)
                if smem_bytes(n_pad, channels, m) <= SMEM_LIMIT), default=0)


def dense_plan(batch: int, channels: int, n_pad: int, refractory: int,
               co_resident: Callable[[int, int, int], int],
               smem_bytes: Callable[[int, int, int], int],
               body: Optional[str] = None) -> DensePlan:
    """The body and tiling of a dense B2/B4 call on `batch` streams of
    `channels` input channels at `n_pad` padded neurons. The cluster body
    wherever its slices fit, else the one-thread body, and the block body
    above 1024 padded neurons; `body` asks for one of them, and raises if
    it cannot take the shape. co_resident(K, threads, smem) is how many
    such clusters the card holds at once (`cluster_capacity` asks the
    card); smem_bytes(n_pad, channels, M) is a CTA's shared memory at M
    streams a round (`cluster_smem` asks csrc/lif.cu, which owns the
    layout). The rounds are as few as those clusters allow, and M as small
    as those rounds allow: M = ceil(B / (clusters x rounds))."""
    if n_pad <= 0 or n_pad % 32:
        raise ValueError(f"dense B2/B4 take N_pad > 0 and N_pad % 32 == 0; got N_pad={n_pad}")
    if body not in (None, *_BODY_CODE):
        raise ValueError(f"unknown body {body!r}")
    if n_pad > _ONE_THREAD_MAX:
        if n_pad % 128 or not 0 <= refractory <= MAX_REFRACTORY:
            raise ValueError(
                f"dense B2/B4 above {_ONE_THREAD_MAX} padded neurons take N_pad % 128 == 0 "
                f"and 0 <= refractory <= {MAX_REFRACTORY}; got N_pad={n_pad} "
                f"refractory={refractory}")
        if body not in (None, BLOCK):
            raise ValueError(f"N_pad={n_pad} runs only on the block body, not {body}")
        return DensePlan(BLOCK)
    m_cap = max_cluster_streams(n_pad, channels, smem_bytes)
    if body == BLOCK or (body == CLUSTER and not m_cap):
        raise ValueError(f"N_pad={n_pad} with {channels} channels has no {body} body")
    if body == ONE_THREAD or not m_cap:
        return DensePlan(ONE_THREAD)
    k = n_pad // CLUSTER_SLICE
    co = int(co_resident(k, 32 * m_cap, smem_bytes(n_pad, channels, m_cap)))
    if co < 1:
        raise ValueError(f"the card holds no cluster of {k} CTAs of the cluster body")
    b = max(int(batch), 1)
    rounds = -(-b // (co * m_cap))
    m = -(-b // (co * rounds))
    clusters = -(-b // (m * rounds))
    # The kernel hands round slots first, first + clusters, ... to a cluster.
    rounds = -(-(-(-b // m)) // clusters)
    return DensePlan(CLUSTER, k, m, 32 * m, smem_bytes(n_pad, channels, m),
                     clusters, rounds, co)


def cluster_smem(n_pad: int, channels: int, streams: int) -> int:
    """The cluster body's bytes of dynamic shared memory a CTA at `streams`
    streams a round, as csrc/lif.cu lays them out."""
    return int(_CLUSTER_SMEM(n_pad, channels, streams))


_capacity: dict = {}


def cluster_capacity(device: torch.device, chunk: bool, k: int, threads: int,
                     smem_bytes: int) -> int:
    """The clusters of k CTAs of the cluster body (B4's if `chunk`, else
    B2's) that `device` holds at once (cudaOccupancyMaxActiveClusters),
    asked once per shape."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, bool(chunk), k, threads, smem_bytes)
    if key not in _capacity:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _CLUSTER_CAPACITY(int(chunk), k, threads, smem_bytes, ctypes.byref(out))
        _build.check(err, "lsm_lif_cluster_capacity")
        _capacity[key] = out.value
    return _capacity[key]


def card_plan(x: torch.Tensor, n_pad: int, refractory: int, chunk: bool,
              body: Optional[str] = None) -> DensePlan:
    """`dense_plan` for spikes x (B, C, T) on their card: B2's plan, or
    B4's if `chunk`; computed once per card and shape."""
    return _card_plan(x.device.index, bool(chunk), x.shape[0], x.shape[1], n_pad,
                      int(refractory), body)


@functools.lru_cache(maxsize=1024)
def _card_plan(index, chunk, batch, channels, n_pad, refractory, body) -> DensePlan:
    device = torch.device("cuda", index)
    return dense_plan(batch, channels, n_pad, refractory,
                      lambda k, th, sm: cluster_capacity(device, chunk, k, th, sm),
                      cluster_smem, body)


def block_scratch(x, n_state, n_slots, n_outputs, chunk, refractory):
    """The global scratch (uint8) of one call of the stream-tiled block
    body (csrc/sparse_lif.cu) on spikes x (B, C, T) at n_state neurons and
    n_slots source blocks a destination block: the K-major weight blocks,
    spike bit planes, input bits, output raster, refrac (8 or 16 bits, as
    `refractory` needs) and, for the batch kernels, v."""
    B, C, T = x.shape
    n_bytes = _SCRATCH_BYTES(B, C, T, n_state, n_slots, n_outputs, int(chunk), int(refractory))
    return alloc_block_scratch(n_bytes, x.device, n_state, n_slots)


def alloc_block_scratch(n_bytes: int, device: torch.device, n_state: int,
                        n_slots: int) -> torch.Tensor:
    """n_bytes of uint8 scratch on `device`. The block body's one limit is
    this allocation: where it fails, the allocator's OutOfMemoryError is
    raised again saying what the scratch holds."""
    try:
        return torch.empty(n_bytes, dtype=torch.uint8, device=device)
    except torch.OutOfMemoryError as err:
        raise torch.OutOfMemoryError(
            f"the block body at {n_state} neurons and {n_slots} source blocks a "
            f"destination block needs {n_bytes / 1e6:.1f} MB of scratch (K-major weight "
            f"blocks, spike planes, state); take fewer streams a call ({err})") from err


def _scratch_ptr(x, plan, n_pad, n_outputs, chunk, refractory):
    """(tensor kept alive for the call, pointer): the block body's scratch
    (the dense matrix as n_pad / 128 slots), none for the other bodies."""
    if plan.body != BLOCK:
        return None, None
    sc = block_scratch(x, n_pad, n_pad // 128, n_outputs, chunk, refractory)
    return sc, sc.data_ptr()


def lif_stats(x, w_rec, w_in, leak_keep, *, threshold, refractory,
              burst_isi_max, n_outputs, n_win, plan: Optional[DensePlan] = None):
    """(stats (11, B, no), all_counts (B, Np)): kernel B2 on CUDA, on the
    body `plan` names (default: `card_plan`'s), the plain twin on CPU."""
    _check(x, w_rec, w_in, leak_keep, n_outputs)
    kw = dict(threshold=threshold, refractory=refractory,
              burst_isi_max=burst_isi_max, n_outputs=n_outputs, n_win=n_win)
    if x.device.type == "cpu":
        return lif_stats_plain(x, w_rec, w_in, leak_keep, **kw)
    n_pad = w_rec.shape[0]
    _check_cuda("B2", x)
    plan = plan or card_plan(x, n_pad, refractory, chunk=False)
    B, C, T = x.shape
    stats = torch.empty(len(STAT_KEYS), B, n_outputs, dtype=torch.float32, device=x.device)
    all_counts = torch.empty(B, n_pad, dtype=torch.float32, device=x.device)
    _keep, scratch = _scratch_ptr(x, plan, n_pad, n_outputs, False, refractory)
    _STATS.launch(x.device, x.data_ptr(), w_rec.data_ptr(), w_in.data_ptr(),
                  leak_keep.data_ptr(), stats.data_ptr(), all_counts.data_ptr(),
                  B, C, T, n_pad, n_outputs, float(threshold), int(refractory),
                  int(burst_isi_max), max(1, T // n_win), int(n_win), *plan.c_args(),
                  scratch, body=plan.body)
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
              refractory, burst_isi_max, n_outputs, win_len, n_new_win,
              plan: Optional[DensePlan] = None):
    """One carried-state chunk: (v, refrac, s_prev, seg (9, B, no),
    win (B, n_new_win, no)). Kernel B4 on CUDA, on the body `plan` names
    (default: `card_plan`'s), the plain twin on CPU."""
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
    _check_cuda("B4", x)
    plan = plan or card_plan(x, n_pad, refractory, chunk=True)
    dev = x.device
    v_out = torch.empty_like(v)
    refrac_out = torch.empty_like(refrac)
    s_out = torch.empty_like(s_prev)
    seg = torch.empty(len(SEG_KEYS), B, n_outputs, dtype=torch.float32, device=dev)
    win = torch.empty(B, n_new_win, n_outputs, dtype=torch.float32, device=dev)
    _keep, scratch = _scratch_ptr(x, plan, n_pad, n_outputs, True, refractory)
    _CHUNK.launch(dev, x.data_ptr(), w_rec.data_ptr(), w_in.data_ptr(), leak_keep.data_ptr(),
                  v.data_ptr(), refrac.data_ptr(), s_prev.data_ptr(),
                  v_out.data_ptr(), refrac_out.data_ptr(), s_out.data_ptr(),
                  seg.data_ptr(), win.data_ptr(),
                  B, C, T, n_pad, n_outputs, float(threshold), int(refractory),
                  int(burst_isi_max), int(win_len), int(n_new_win), *plan.c_args(),
                  scratch, body=plan.body)
    return v_out, refrac_out, s_out, seg, win
