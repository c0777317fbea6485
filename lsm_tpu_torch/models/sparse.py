"""The block-sparse reservoir for scaled configurations (port of
lsm_tpu/models/sparse.py; BASELINE.json configs[3], 10240 neurons).

The recurrent matrix of a directed Watts-Strogatz reservoir is ~90 % zeros
(out-degree k/2 = 0.1 N). The ring band (edges i -> i+1..i+k/2) is already
block-banded, so for sparse reservoirs the rewired edges (fraction
small_world_p) land inside R random long-range PARTNER blocks of their
source block (a fresh random block permutation per r, so every block also
receives exactly R partner blocks). Out-degree stays k/2 per neuron and the
weights keep the N(mean_weight, (|mw| sqrt(weight_variance))^2)
distribution; the reservoir contract is statistical, held by the regime and
accuracy oracles.

Storage: w_blocks (nb, S, 128, 128) with S = n_band + R and src_idx
(nb, S) naming the source block of each slot; per step the drive of
destination block j is sum_s s_prev[block src_idx[j, s]] @ w_blocks[j, s]
(kernel B5 on CUDA, B6 for a continuous chunk; plain twins on the CPU).

lsm_tpu draws this structure with jax.random; the port draws the same
structure and distributions from one CPU torch.Generator seeded with
cfg.seed, so a seed gives the same weights on the CPU and on the card but
not lsm_tpu's bits. Parity with lsm_tpu goes through
`convert.sparse_reservoir`, which carries its arrays across.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from lsm_tpu_torch.config import ReservoirConfig
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.ops.kernels import lif
from lsm_tpu_torch.ops.kernels import sparse_lif
from lsm_tpu_torch.ops.kernels.sparse_lif import BLOCK, sparse_drive  # noqa: F401


class SparseReservoir(nn.Module):
    """Block-sparse reservoir weights as buffers: w_blocks (nb, S, 128, 128)
    f32, where w_blocks[j, s] is the block from source block src_idx[j, s]
    into destination block j (slots 0..n_band-1 the ring band at distance
    s behind j, then the R partner blocks), src_idx (nb, S) int32, w_in
    (C_pad, N) f32 and leak (N,) f32; plus the static simulation fields.
    Kernel B5/B6's operands (bf16 weights, 1 - leak) are made once and held
    as non-persistent buffers."""

    def __init__(self, w_blocks, src_idx, w_in, leak, *, n_neurons: int, n_outputs: int,
                 n_channels: int, threshold: float, refractory: int, burst_isi_max: int,
                 n_rate_windows: int, n_band: int):
        super().__init__()
        self.register_buffer("w_blocks", torch.as_tensor(w_blocks, dtype=torch.float32))
        self.register_buffer("src_idx", torch.as_tensor(src_idx, dtype=torch.int32))
        self.register_buffer("w_in", torch.as_tensor(w_in, dtype=torch.float32))
        self.register_buffer("leak", torch.as_tensor(leak, dtype=torch.float32))
        self.register_buffer("w_blocks_bf16", self.w_blocks.to(torch.bfloat16),
                             persistent=False)
        self.register_buffer("w_in_bf16", self.w_in.to(torch.bfloat16), persistent=False)
        self.register_buffer("leak_keep", (1.0 - self.leak).contiguous(), persistent=False)
        self.n_neurons = int(n_neurons)
        self.n_outputs = int(n_outputs)
        self.n_channels = int(n_channels)
        self.threshold = float(threshold)
        self.refractory = int(refractory)
        self.burst_isi_max = int(burst_isi_max)
        self.n_rate_windows = int(n_rate_windows)
        self.n_band = int(n_band)

    def kernel_operands(self) -> Tuple[Tuple[torch.Tensor, ...], dict]:
        """Kernel B5's arguments: ((w_blocks bf16, src_idx int32, w_in bf16,
        1 - leak f32), keyword arguments), for
        `sparse_lif.sparse_lif_stats(spikes, *ops, **kw)` and its twin."""
        return (self.w_blocks_bf16, self.src_idx, self.w_in_bf16, self.leak_keep), dict(
            threshold=self.threshold, refractory=self.refractory,
            burst_isi_max=self.burst_isi_max, n_outputs=self.n_outputs,
            n_win=self.n_rate_windows,
        )

    def dyadic(self) -> "SparseReservoir":
        """A copy with the weights snapped to multiples of 1/256 and zero
        leak (tests/test_sparse_reservoir.py's recipe): every sum is exact
        in float32, so the kernels and their twins agree bit for bit."""
        q = lambda a: torch.round(a * 256.0) / 256.0
        return SparseReservoir(
            q(self.w_blocks), self.src_idx, q(self.w_in), torch.zeros_like(self.leak),
            **self._fields(),
        )

    def _fields(self) -> dict:
        return dict(n_neurons=self.n_neurons, n_outputs=self.n_outputs,
                    n_channels=self.n_channels, threshold=self.threshold,
                    refractory=self.refractory, burst_isi_max=self.burst_isi_max,
                    n_rate_windows=self.n_rate_windows, n_band=self.n_band)

    def forward(self, spikes: torch.Tensor, feature_keys: Tuple[str, ...]) -> torch.Tensor:
        return res.extract_features(self, spikes, feature_keys)


def _scatter_set(size: int, flat: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A (size,) f32 vector with values[i] at flat[i]; where several edges
    share an index the last one drawn wins (a sequential scatter-set, made
    deterministic: the winner is the largest edge number)."""
    order = torch.arange(flat.numel())
    winner = torch.full((size,), -1, dtype=torch.int64).scatter_reduce_(
        0, flat, order, "amax")
    out = torch.zeros(size, dtype=torch.float32)
    hit = winner >= 0
    out[hit] = values[winner[hit]]
    return out


def init_reservoir_sparse(
    cfg: ReservoirConfig,
    n_channels: int,
    mean_weight: Optional[float] = None,
    device: torch.device | str = "cpu",
) -> SparseReservoir:
    """The block-sparse structure of lsm_tpu's `init_reservoir_sparse`
    drawn from one CPU torch.Generator seeded with cfg.seed, then moved to
    `device`: a ring band of n_band blocks, R random block permutations for
    the rewired edges, the self-loop bump within the partner block, a
    scatter-set within a slot (duplicate edges collapse) and a sum across
    slots (the simulation and `densify` add them). Requires
    num_neurons % 128 == 0."""
    n = cfg.num_neurons
    if n % BLOCK:
        raise ValueError(f"block-sparse reservoir needs num_neurons % {BLOCK} == 0, got {n}")
    R = cfg.sparse_partner_blocks
    if R < 1:
        raise ValueError("sparse_partner_blocks must be >= 1")
    nb = n // BLOCK
    half = cfg.small_world_k // 2
    if not 1 <= half < n:
        raise ValueError(f"small_world_k/2 must be in [1, N), got {half}")
    n_band = (BLOCK - 1 + half) // BLOCK + 1
    S = n_band + R
    c_pad = res._round_up(n_channels)
    mw = cfg.mean_weight if mean_weight is None else mean_weight
    std = abs(mw) * math.sqrt(cfg.weight_variance)
    gen = torch.Generator().manual_seed(cfg.seed)

    # R random block permutations: source block a rewires into perms[r, a];
    # block j receives partner slot r from inv_perms[r, j].
    perms = torch.stack([torch.randperm(nb, generator=gen) for _ in range(R)])
    inv_perms = torch.argsort(perms, dim=1)

    # Per-edge arrays (half, n): row = ring offset - 1, column = source.
    src = torch.arange(n)[None, :]
    src_blk = src // BLOCK
    ring_dst = (src + torch.arange(1, half + 1)[:, None]) % n
    rewire = torch.rand(half, n, generator=gen) < cfg.small_world_p
    r_choice = torch.randint(0, R, (half, n), generator=gen)
    part_blk = perms[r_choice, src_blk.expand(half, n)]
    dst_off = torch.randint(0, BLOCK, (half, n), generator=gen)
    # A rewired self-loop moves to the next lane of the block.
    dst_off = torch.where(part_blk * BLOCK + dst_off == src, (dst_off + 1) % BLOCK, dst_off)
    dst = torch.where(rewire, part_blk * BLOCK + dst_off, ring_dst)
    dst_blk = dst // BLOCK
    slot = torch.where(rewire, n_band + r_choice, (dst_blk - src_blk) % nb)
    flat = ((dst_blk * S + slot) * BLOCK + src % BLOCK) * BLOCK + dst % BLOCK
    wvals = torch.randn(half, n, generator=gen) * std + mw
    w_blocks = _scatter_set(nb * S * BLOCK * BLOCK, flat.reshape(-1),
                            wvals.reshape(-1)).view(nb, S, BLOCK, BLOCK)

    j = torch.arange(nb)
    band_src = (j[:, None] - torch.arange(n_band)[None, :]) % nb
    src_idx = torch.cat([band_src, inv_perms.T], dim=1).to(torch.int32)   # (nb, S)

    w_in = res.device_input_projection(gen, n_channels, n, c_pad, n,
                                       min(cfg.input_fanout, n), cfg.input_weight)
    leak = res.device_leak_draw(gen, cfg, n, n)
    return SparseReservoir(
        w_blocks, src_idx, w_in, leak,
        n_neurons=n, n_outputs=cfg.num_output_neurons, n_channels=n_channels,
        threshold=cfg.membrane_threshold, refractory=cfg.refractory_period,
        burst_isi_max=cfg.burst_isi_max, n_rate_windows=cfg.n_rate_windows,
        n_band=n_band,
    ).to(device)


def densify(sr: SparseReservoir) -> res.Reservoir:
    """The dense `Reservoir` with the same dynamics (an oracle; host-side
    loop). Slots that name the same (source, destination) block pair are
    summed, in slot order, as the simulation sums them."""
    wb = sr.w_blocks.cpu()
    src_idx = sr.src_idx.cpu()
    nb, S = src_idx.shape
    n = nb * BLOCK
    w = torch.zeros(n, n, dtype=torch.float32)
    for j in range(nb):
        for s in range(S):
            a = int(src_idx[j, s])
            w[a * BLOCK:(a + 1) * BLOCK, j * BLOCK:(j + 1) * BLOCK] += wb[j, s]
    return res.Reservoir(
        w, sr.w_in.cpu(), sr.leak.cpu(), n_neurons=sr.n_neurons, n_outputs=sr.n_outputs,
        n_channels=sr.n_channels, threshold=sr.threshold, refractory=sr.refractory,
        burst_isi_max=sr.burst_isi_max, n_rate_windows=sr.n_rate_windows,
    ).to(sr.w_in.device)


def simulate_batch_sparse(sr: SparseReservoir, spikes_in: torch.Tensor) -> Dict[str, torch.Tensor]:
    """`reservoir.simulate_batch` for the block-sparse reservoir (kernel B5
    on CUDA, its plain twin on CPU): the same statistics contract."""
    ops, kw = sr.kernel_operands()
    stats, all_counts = sparse_lif.sparse_lif_stats(
        spikes_in.to(torch.uint8).contiguous(), *ops, **kw)
    out = dict(zip(lif.STAT_KEYS, stats.unbind(0)))
    out["n_win_used"] = float(sr.n_rate_windows)
    out["all_counts"] = all_counts
    return out


def extract_features_sparse(
    sr: SparseReservoir, spikes_in: torch.Tensor, feature_keys: Tuple[str, ...]
) -> torch.Tensor:
    """spikes (B, C, T) -> features (B, len(keys) * n_outputs)."""
    return res.features_from_stats(simulate_batch_sparse(sr, spikes_in), feature_keys)


def simulate_chunk_sparse(sr: SparseReservoir, spikes_in, v, refrac, s_prev,
                          win_len: int, n_new_win: int):
    """One continuous-mode chunk from the carried (B, N) state (kernel B6 on
    CUDA, its plain twin on CPU); the contract of `reservoir.simulate_chunk`."""
    ops, kw = sr.kernel_operands()
    del kw["n_win"]
    v, refrac, s_prev, seg, win = sparse_lif.sparse_lif_chunk(
        spikes_in.to(torch.uint8).contiguous(), *ops, v, refrac, s_prev, **kw,
        win_len=win_len, n_new_win=n_new_win,
    )
    return v, refrac, s_prev, dict(zip(lif.SEG_KEYS, seg.unbind(0))), win
