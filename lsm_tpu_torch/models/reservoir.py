"""The dense LIF reservoir (port of lsm_tpu/models/reservoir.py).

    v_t = (1 - leak) * v_{t-1} + s_{t-1} @ W_rec + x_t @ W_in
    s_t = (v_t >= threshold) & not_refractory;  reset + refractory clamp

Below 4096 neurons the weights are drawn on the host with NumPy exactly as
the reference's host path draws them (same rng calls in the same order), so
`init_reservoir` gives bit-equal w_rec, w_in and leak. From 4096 neurons on
it draws on the target device as lsm_tpu does there
(`init_reservoir_device`): the same structure and distributions from a
torch.Generator, not jax.random's bits. The simulation with its streaming
statistics is kernel B2 (ops/kernels/lif.py) on CUDA and its plain twin on
the CPU; both use bf16 weight operands with f32 accumulation and f32 state.
The continuous engine runs one chunk at a time with the state carried
(`simulate_chunk`, kernel B4), reduces each chunk to a segment summary and
folds a ring of them into whole-window statistics (`segment_summary`,
`fold_segment_stats`). The block-sparse reservoir of scaled configurations
is models/sparse.py (kernels B5, B6); `simulate_batch`, `simulate_chunk` and
`extract_features` dispatch on the reservoir's type.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from lsm_tpu_torch.config import ReservoirConfig
from lsm_tpu_torch.ops.kernels import lif

_ROUND = 128
# From this many neurons on, the weights are drawn on the device (lsm_tpu's
# _DEVICE_INIT_THRESHOLD): no (N, N) host matrix, no host-to-device copy.
_DEVICE_INIT_THRESHOLD = 4096


def _round_up(x: int, m: int = _ROUND) -> int:
    return -(-x // m) * m


def watts_strogatz_adjacency(n: int, k: int, p: float, rng: np.random.Generator) -> np.ndarray:
    """DIRECTED Watts-Strogatz adjacency (n, n) bool, adj[src, dst], with
    out-degree k/2: each node projects to its k/2 clockwise neighbours, each
    edge rewired to a random target with probability p."""
    adj = np.zeros((n, n), dtype=bool)
    half = k // 2
    nodes = np.arange(n)
    for j in range(1, half + 1):
        targets = (nodes + j) % n
        rewire = rng.random(n) < p
        new_targets = rng.integers(0, n, size=n)
        targets = np.where(rewire, new_targets, targets)
        self_loop = targets == nodes
        targets = np.where(self_loop, (nodes + j + half) % n, targets)
        adj[nodes, targets] = True
    np.fill_diagonal(adj, False)
    return adj


class Reservoir(nn.Module):
    """Reservoir weights as buffers, padded to lane multiples:
    w_rec (N_pad, N_pad) f32 with row = source, w_in (C_pad, N_pad) f32,
    leak (N_pad,) f32; plus the static simulation fields. The weights are
    fixed at construction, so kernel B2's operands (bf16 weights and
    1 - leak) are made once and held as non-persistent buffers."""

    def __init__(self, w_rec, w_in, leak, *, n_neurons: int, n_outputs: int,
                 n_channels: int, threshold: float, refractory: int,
                 burst_isi_max: int, n_rate_windows: int):
        super().__init__()
        self.register_buffer("w_rec", torch.as_tensor(w_rec, dtype=torch.float32))
        self.register_buffer("w_in", torch.as_tensor(w_in, dtype=torch.float32))
        self.register_buffer("leak", torch.as_tensor(leak, dtype=torch.float32))
        self.register_buffer("w_rec_bf16", self.w_rec.to(torch.bfloat16), persistent=False)
        self.register_buffer("w_in_bf16", self.w_in.to(torch.bfloat16), persistent=False)
        self.register_buffer("leak_keep", (1.0 - self.leak).contiguous(), persistent=False)
        self.n_neurons = int(n_neurons)
        self.n_outputs = int(n_outputs)
        self.n_channels = int(n_channels)
        self.threshold = float(threshold)
        self.refractory = int(refractory)
        self.burst_isi_max = int(burst_isi_max)
        self.n_rate_windows = int(n_rate_windows)

    def kernel_operands(self) -> Tuple[Tuple[torch.Tensor, ...], dict]:
        """Kernel B2's arguments: ((w_rec bf16, w_in bf16, 1 - leak f32),
        keyword arguments), for `lif.lif_stats(spikes, *ops, **kw)` and
        its plain twin."""
        return (self.w_rec_bf16, self.w_in_bf16, self.leak_keep), dict(
            threshold=self.threshold, refractory=self.refractory,
            burst_isi_max=self.burst_isi_max, n_outputs=self.n_outputs,
            n_win=self.n_rate_windows,
        )

    def dyadic(self) -> "Reservoir":
        """A copy with the weights snapped to multiples of 1/256 and zero
        leak (the recipe of tests/test_reservoir.py). Every sum is then
        exact in float32 and the weights are exact in bf16, so spike
        decisions cannot depend on summation order: the kernel and its
        plain twin must agree bit for bit."""
        q = lambda a: torch.round(a * 256.0) / 256.0
        return Reservoir(
            q(self.w_rec), q(self.w_in), torch.zeros_like(self.leak),
            n_neurons=self.n_neurons, n_outputs=self.n_outputs,
            n_channels=self.n_channels, threshold=self.threshold,
            refractory=self.refractory, burst_isi_max=self.burst_isi_max,
            n_rate_windows=self.n_rate_windows,
        )

    def forward(self, spikes: torch.Tensor, feature_keys: Tuple[str, ...]) -> torch.Tensor:
        return extract_features(self, spikes, feature_keys)


def init_reservoir(
    cfg: ReservoirConfig,
    n_channels: int,
    mean_weight: Optional[float] = None,
    device: torch.device | str = "cpu",
) -> Reservoir:
    """Topology and weights, deterministic in cfg.seed: the reference's
    NumPy host path below 4096 neurons, `init_reservoir_device` from 4096
    on (lsm_tpu's rule)."""
    if cfg.num_neurons >= _DEVICE_INIT_THRESHOLD:
        return init_reservoir_device(cfg, n_channels, mean_weight, device)
    rng = np.random.default_rng(cfg.seed)
    n, n_pad = cfg.num_neurons, _round_up(cfg.num_neurons)
    c_pad = _round_up(n_channels)
    mw = cfg.mean_weight if mean_weight is None else mean_weight

    adj = watts_strogatz_adjacency(n, cfg.small_world_k, cfg.small_world_p, rng)
    std = abs(mw) * np.sqrt(cfg.weight_variance)
    weights = rng.standard_normal((n, n), dtype=np.float32) * np.float32(std)
    weights += np.float32(mw)
    weights *= adj
    w_rec = np.zeros((n_pad, n_pad), dtype=np.float32)
    w_rec[:n, :n] = weights

    w_in = np.zeros((c_pad, n_pad), dtype=np.float32)
    fanout = min(cfg.input_fanout, n)
    for c in range(n_channels):
        targets = rng.choice(n, size=fanout, replace=False)
        w_in[c, targets] += cfg.input_weight

    if cfg.leak_variance_divisor:
        leak_n = rng.normal(
            cfg.leak_coefficient,
            cfg.leak_coefficient / cfg.leak_variance_divisor,
            size=n,
        ).clip(0.0, 1.0)
    else:
        leak_n = np.full(n, cfg.leak_coefficient)
    leak = np.zeros(n_pad, dtype=np.float32)
    leak[:n] = leak_n

    return Reservoir(
        w_rec, w_in, leak,
        n_neurons=n,
        n_outputs=cfg.num_output_neurons,
        n_channels=n_channels,
        threshold=cfg.membrane_threshold,
        refractory=cfg.refractory_period,
        burst_isi_max=cfg.burst_isi_max,
        n_rate_windows=cfg.n_rate_windows,
    ).to(device)


def init_reservoir_device(
    cfg: ReservoirConfig,
    n_channels: int,
    mean_weight: Optional[float] = None,
    device: torch.device | str = "cpu",
) -> Reservoir:
    """lsm_tpu's `_init_reservoir_device`, drawn from one torch.Generator on
    `device` seeded with cfg.seed, every array made there (no (N, N) host
    matrix, no host-to-device copy): the directed Watts-Strogatz ring of
    k/2 offsets, each edge rewired to a uniform target with probability
    small_world_p, a rewired self-loop moved to offset + k/2, the
    diagonal cleared (duplicate targets collapse, so a row may keep a few
    fewer than k/2 edges), N(mean_weight, (|mean_weight|
    sqrt(weight_variance))^2) weights on the mask, the input projection as
    the top `fanout` of per-channel uniform scores and the leak draw. The
    same structure and distributions as lsm_tpu's, not its bits; a
    generator's stream differs between the CPU and the card."""
    dev = torch.device(device)
    n, n_pad = cfg.num_neurons, _round_up(cfg.num_neurons)
    mw = cfg.mean_weight if mean_weight is None else mean_weight
    half = cfg.small_world_k // 2
    std = abs(mw) * math.sqrt(cfg.weight_variance)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    rows = torch.arange(n, device=dev)
    offsets = torch.arange(1, half + 1, device=dev)[:, None]
    ring = (rows + offsets) % n                                          # (half, n)
    rewire = torch.rand(half, n, generator=gen, device=dev) < cfg.small_world_p
    new_t = torch.randint(0, n, (half, n), generator=gen, device=dev)
    targets = torch.where(rewire, new_t, ring)
    targets = torch.where(targets == rows, (rows + offsets + half) % n, targets)
    mask = torch.zeros(n_pad, n_pad, dtype=torch.bool, device=dev)
    mask[rows.expand(half, n), targets] = True
    mask[rows, rows] = False                                             # no self-loops
    del ring, rewire, new_t, targets

    w_rec = torch.randn(n_pad, n_pad, generator=gen, device=dev).mul_(std).add_(mw)
    w_rec.masked_fill_(~mask, 0.0)
    del mask
    w_in = device_input_projection(gen, n_channels, n, _round_up(n_channels), n_pad,
                                   min(cfg.input_fanout, n), cfg.input_weight)
    leak = device_leak_draw(gen, cfg, n, n_pad)
    return Reservoir(
        w_rec, w_in, leak,
        n_neurons=n,
        n_outputs=cfg.num_output_neurons,
        n_channels=n_channels,
        threshold=cfg.membrane_threshold,
        refractory=cfg.refractory_period,
        burst_isi_max=cfg.burst_isi_max,
        n_rate_windows=cfg.n_rate_windows,
    )


def device_input_projection(gen: torch.Generator, n_channels: int, n: int, c_pad: int,
                            width: int, fanout: int, weight: float) -> torch.Tensor:
    """(c_pad, width) f32 input projection on gen's device: `fanout`
    distinct target neurons per channel at `weight`, the top of
    per-channel uniform scores (rng.choice(n, fanout, replace=False)
    semantics; lsm_tpu's `device_input_projection`, drawn from `gen`)."""
    dev = gen.device
    scores = torch.rand(n_channels, n, generator=gen, device=dev)
    proj = torch.topk(scores, fanout, dim=1).indices                  # (C, fanout)
    w_in = torch.zeros(c_pad, width, dtype=torch.float32, device=dev)
    w_in[torch.arange(n_channels, device=dev)[:, None], proj] += weight
    return w_in


def device_leak_draw(gen: torch.Generator, cfg: ReservoirConfig, n: int,
                     width: int) -> torch.Tensor:
    """Per-neuron leak on gen's device, heterogeneous N(leak, (leak /
    divisor)^2) clipped to [0, 1] when cfg.leak_variance_divisor is set,
    padded to `width` (lsm_tpu's `device_leak_draw`, drawn from `gen`)."""
    leak = torch.zeros(width, dtype=torch.float32, device=gen.device)
    if cfg.leak_variance_divisor:
        leak[:n] = torch.clamp(
            cfg.leak_coefficient + torch.randn(n, generator=gen, device=gen.device)
            * (cfg.leak_coefficient / cfg.leak_variance_divisor), 0.0, 1.0)
    else:
        leak[:n] = cfg.leak_coefficient
    return leak


def simulate_batch(res, spikes_in: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Run the reservoir over (B, C, T) 0/1 spikes with streaming statistics
    (a dense `Reservoir` through kernel B2, a `SparseReservoir` through B5).

    Returns (B, n_outputs) f32 accumulators counts, sum_t, sum_t2, first
    (inf if silent), last (-1 if silent), n_isi, sum_isi, sum_isi2, bursts,
    win_sum, win_sum2 (moments of the per-window counts over n_win_used
    windows), plus all_counts (B, n_neurons) over the whole reservoir."""
    if not isinstance(res, Reservoir):
        from lsm_tpu_torch.models.sparse import simulate_batch_sparse

        return simulate_batch_sparse(res, spikes_in)
    ops, kw = res.kernel_operands()
    stats, all_counts = lif.lif_stats(spikes_in.to(torch.uint8).contiguous(), *ops, **kw)
    out = dict(zip(lif.STAT_KEYS, stats.unbind(0)))
    out["n_win_used"] = float(res.n_rate_windows)
    out["all_counts"] = all_counts[:, : res.n_neurons]
    return out


def simulate_chunk(
    res,
    spikes_in: torch.Tensor,      # (B, C, T_c) 0/1
    v: torch.Tensor,              # (B, width) f32
    refrac: torch.Tensor,         # (B, width) int32
    s_prev: torch.Tensor,         # (B, width) f32
    win_len: int,
    n_new_win: int,
):
    """One continuous-mode chunk from the carried state (kernel B4 on CUDA
    for a dense `Reservoir`, width N_pad; B6 for a `SparseReservoir`, width
    N; the plain twins on CPU). Returns (v, refrac, s_prev, segment summary
    dict of (B, no) with segment-relative times, win_counts
    (B, n_new_win, no))."""
    if not isinstance(res, Reservoir):
        from lsm_tpu_torch.models.sparse import simulate_chunk_sparse

        return simulate_chunk_sparse(res, spikes_in, v, refrac, s_prev, win_len, n_new_win)
    ops, kw = res.kernel_operands()
    del kw["n_win"]
    v, refrac, s_prev, seg, win = lif.lif_chunk(
        spikes_in.to(torch.uint8).contiguous(), *ops, v, refrac, s_prev, **kw,
        win_len=win_len, n_new_win=n_new_win,
    )
    return v, refrac, s_prev, dict(zip(lif.SEG_KEYS, seg.unbind(0))), win


def segment_summary(raster: torch.Tensor, burst_isi_max: int) -> Dict[str, torch.Tensor]:
    """Statistics of one segment's (B, T_c, no) bool output raster with
    SEGMENT-RELATIVE times, vectorized over T (lsm_tpu's `segment_summary`):
    counts, sum_t, sum_t2, first (inf if silent), last (-1 if silent), and
    the ISI moments and bursts of spike pairs internal to the segment (the
    fold reconstructs the pairs that cross a boundary). Each spike's
    previous-spike time is an inclusive cummax of (t if spike else -1)
    shifted by one step."""
    B, T, no = raster.shape
    sof = raster.to(torch.float32)
    tf = torch.arange(T, dtype=torch.float32, device=raster.device).view(1, T, 1)
    counts = sof.sum(dim=1)
    sum_t = (sof * tf).sum(dim=1)
    sum_t2 = (sof * tf * tf).sum(dim=1)
    first = torch.where(raster, tf, float("inf")).amin(dim=1)
    marks = torch.where(raster, tf, -1.0)
    last = marks.amax(dim=1)
    m = torch.cummax(marks, dim=1).values
    prev_t = torch.cat([torch.full_like(m[:, :1], -1.0), m[:, :-1]], dim=1)
    isi_event = raster & (prev_t >= 0.0)
    isi = torch.where(isi_event, tf - prev_t, 0.0)
    return dict(
        counts=counts, sum_t=sum_t, sum_t2=sum_t2, first=first, last=last,
        n_isi=isi_event.to(torch.float32).sum(dim=1),
        sum_isi=isi.sum(dim=1),
        sum_isi2=(isi * isi).sum(dim=1),
        bursts=(isi_event & (isi <= burst_isi_max)).to(torch.float32).sum(dim=1),
    )


def fold_segment_stats(
    segs: Dict[str, torch.Tensor],  # each (n_ring, B, no); ring[0] = oldest
    seg_len: int,
    burst_isi_max: int,
) -> Dict[str, torch.Tensor]:
    """Combine consecutive segment summaries into whole-window statistics
    (times relative to segment 0's start), in ring (age) order, op for op as
    lsm_tpu's `fold_segment_stats`: sums shift by the segment offset,
    first/last are offset min/max, and the one ISI that crosses into each
    non-empty segment runs from the previous non-empty segment's last spike
    to its first. Integer-valued fields are exact in f32; sum_t2 and
    sum_isi2 carry f32 rounding beyond 2^24."""
    n_ring = segs["counts"].shape[0]
    counts = torch.sum(segs["counts"], dim=0)
    sum_t = counts * 0.0
    sum_t2 = counts * 0.0
    first = torch.full_like(counts, float("inf"))
    last = torch.full_like(counts, -1.0)
    n_isi = torch.sum(segs["n_isi"], dim=0)
    sum_isi = torch.sum(segs["sum_isi"], dim=0)
    sum_isi2 = torch.sum(segs["sum_isi2"], dim=0)
    bursts = torch.sum(segs["bursts"], dim=0)

    carry_last = torch.full_like(counts, -1.0)
    for k in range(n_ring):
        off = float(k * seg_len)
        ck = segs["counts"][k]
        has = ck > 0
        fk = segs["first"][k] + off            # inf stays inf when silent
        lk = segs["last"][k]
        sum_t = sum_t + segs["sum_t"][k] + off * ck
        sum_t2 = sum_t2 + segs["sum_t2"][k] + 2.0 * off * segs["sum_t"][k] \
            + off * off * ck
        first = torch.minimum(first, torch.where(has, fk, float("inf")))
        last = torch.maximum(last, torch.where(has, lk + off, -1.0))
        cross = has & (carry_last >= 0.0)
        isi = torch.where(cross, fk - carry_last, 0.0)
        n_isi = n_isi + cross.to(torch.float32)
        sum_isi = sum_isi + isi
        sum_isi2 = sum_isi2 + isi * isi
        bursts = bursts + (cross & (isi <= burst_isi_max)).to(torch.float32)
        carry_last = torch.where(has, lk + off, carry_last)

    return dict(
        counts=counts, sum_t=sum_t, sum_t2=sum_t2, first=first, last=last,
        n_isi=n_isi, sum_isi=sum_isi, sum_isi2=sum_isi2, bursts=bursts,
    )


def features_from_stats(
    stats: Dict[str, torch.Tensor], feature_keys: Tuple[str, ...]
) -> torch.Tensor:
    """Per-neuron feature vectors from the accumulators, concatenated in
    feature-set order; NaN-producing entries of silent neurons are 0. The
    rate-window variance comes from `win_counts` (B, no, n_win) when the
    stats carry it (the continuous engine's ring), else from the streaming
    moments win_sum / win_sum2 over n_win_used windows."""
    counts = stats["counts"]
    fired = counts > 0
    n_isi = stats["n_isi"]
    has_isi = n_isi > 0

    safe_counts = torch.clamp(counts, min=1.0)
    safe_n_isi = torch.clamp(n_isi, min=1.0)
    mean_isi = stats["sum_isi"] / safe_n_isi
    if "win_counts" in stats:
        win = stats["win_counts"]
        win_mean = torch.mean(win, dim=-1)
        win_var = torch.mean(win * win, dim=-1) - win_mean * win_mean
    else:
        nw = stats["n_win_used"]
        win_mean = stats["win_sum"] / nw
        win_var = stats["win_sum2"] / nw - win_mean * win_mean

    derived = {
        "spike_counts": counts,
        "spike_variances": torch.where(fired, torch.clamp(win_var, min=0.0), 0.0),
        "mean_spike_times": torch.where(fired, stats["sum_t"] / safe_counts, 0.0),
        "first_spike_times": torch.where(fired, stats["first"], 0.0),
        "last_spike_times": torch.where(fired, stats["last"], 0.0),
        "mean_isi": torch.where(has_isi, mean_isi, 0.0),
        "isi_variances": torch.where(
            has_isi,
            torch.clamp(stats["sum_isi2"] / safe_n_isi - mean_isi * mean_isi, min=0.0),
            0.0,
        ),
        "burst_counts": stats["bursts"],
    }
    return torch.cat([derived[k] for k in feature_keys], dim=-1)


def extract_features(
    res, spikes_in: torch.Tensor, feature_keys: Tuple[str, ...]
) -> torch.Tensor:
    """spikes (B, C, T) -> features (B, len(keys) * n_outputs), for a dense
    `Reservoir` or a `SparseReservoir`."""
    return features_from_stats(simulate_batch(res, spikes_in), feature_keys)
