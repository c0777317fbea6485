"""A configuration's weights, readout and scaler, made from the run's seed
on the device, in a few large calls of one torch.Generator.

The benchmark makes these itself and hands the same tensors to the program
(through its module constructors) and to the plain reference; it takes
none from the program. The reservoir's structure and distributions are the
configuration's: a directed Watts-Strogatz graph of out-degree k/2
rewired with probability p, weights N(mean_weight, (|mean_weight|
sqrt(weight_variance))^2) on its edges, `input_fanout` input edges of
`input_weight` a channel, leak `leak_coefficient`. The dense draw follows
lsm_tpu_torch's `init_reservoir_device`, the block-sparse one its
`init_reservoir_sparse` (a ring band of 128-neuron blocks plus R random
partner blocks a source block), both moved onto the device generator.

The readout is N(0, readout_std) with zero intercept. The scaler's
mean and scale are, per feature, the configuration's typical value for
that feature kind times a uniform draw in [0.5, 1.5), so that standardized
features are of order one.
"""

from __future__ import annotations

import math

import torch

BLOCK = 128


def _round_up(x: int, m: int = BLOCK) -> int:
    return -(-x // m) * m


def _input_projection(gen, n_channels: int, n: int, width: int, fanout: int,
                      weight: float) -> torch.Tensor:
    dev = gen.device
    scores = torch.rand(n_channels, n, generator=gen, device=dev)
    proj = torch.topk(scores, fanout, dim=1).indices
    w_in = torch.zeros(_round_up(n_channels), width, dtype=torch.float32, device=dev)
    w_in[torch.arange(n_channels, device=dev)[:, None], proj] = weight
    return w_in


def _leak(r: dict, n: int, width: int, dev) -> torch.Tensor:
    leak = torch.zeros(width, dtype=torch.float32, device=dev)
    leak[:n] = r["leak_coefficient"]
    return leak


def dense(r: dict, n_channels: int, mean_weight: float, gen: torch.Generator) -> dict:
    """w_rec (N_pad, N_pad) f32 with row = source, w_in (C_pad, N_pad), leak
    (N_pad,): the port's dense `Reservoir` layout."""
    dev = gen.device
    n, n_pad = r["num_neurons"], _round_up(r["num_neurons"])
    half = r["small_world_k"] // 2
    std = abs(mean_weight) * math.sqrt(r["weight_variance"])
    rows = torch.arange(n, device=dev)
    offsets = torch.arange(1, half + 1, device=dev)[:, None]
    ring = (rows + offsets) % n
    rewire = torch.rand(half, n, generator=gen, device=dev) < r["small_world_p"]
    new_t = torch.randint(0, n, (half, n), generator=gen, device=dev)
    targets = torch.where(rewire, new_t, ring)
    targets = torch.where(targets == rows, (rows + offsets + half) % n, targets)
    mask = torch.zeros(n_pad, n_pad, dtype=torch.bool, device=dev)
    mask[rows.expand(half, n), targets] = True
    mask[rows, rows] = False
    w_rec = torch.randn(n_pad, n_pad, generator=gen, device=dev).mul_(std).add_(mean_weight)
    w_rec.masked_fill_(~mask, 0.0)
    w_in = _input_projection(gen, n_channels, n, n_pad, min(r["input_fanout"], n),
                             r["input_weight"])
    return {"w_rec": w_rec, "w_in": w_in, "leak": _leak(r, n, n_pad, dev)}


def block_sparse(r: dict, n_channels: int, mean_weight: float, gen: torch.Generator) -> dict:
    """w_blocks (nb, S, 128, 128) f32, w_blocks[j, s] the block from source
    block src_idx[j, s] into destination block j (slots 0..n_band-1 the
    ring band, then R partner blocks), src_idx (nb, S) int32, w_in
    (C_pad, N), leak (N,): the port's `SparseReservoir` layout. Where
    several edges land on one weight the one drawn last is kept; slots that
    name the same block pair add."""
    dev = gen.device
    n = r["num_neurons"]
    if n % BLOCK:
        raise ValueError(f"a block-sparse reservoir needs N % {BLOCK} == 0, got {n}")
    R = r["sparse_partner_blocks"]
    nb, half = n // BLOCK, r["small_world_k"] // 2
    n_band = (BLOCK - 1 + half) // BLOCK + 1
    S = n_band + R
    std = abs(mean_weight) * math.sqrt(r["weight_variance"])

    perms = torch.stack([torch.randperm(nb, generator=gen, device=dev) for _ in range(R)])
    inv_perms = torch.argsort(perms, dim=1)
    src = torch.arange(n, device=dev)[None, :]
    src_blk = src // BLOCK
    ring_dst = (src + torch.arange(1, half + 1, device=dev)[:, None]) % n
    rewire = torch.rand(half, n, generator=gen, device=dev) < r["small_world_p"]
    r_choice = torch.randint(0, R, (half, n), generator=gen, device=dev)
    part_blk = perms[r_choice, src_blk.expand(half, n)]
    dst_off = torch.randint(0, BLOCK, (half, n), generator=gen, device=dev)
    dst_off = torch.where(part_blk * BLOCK + dst_off == src, (dst_off + 1) % BLOCK, dst_off)
    dst = torch.where(rewire, part_blk * BLOCK + dst_off, ring_dst)
    dst_blk = dst // BLOCK
    slot = torch.where(rewire, n_band + r_choice, (dst_blk - src_blk) % nb)
    flat = (((dst_blk * S + slot) * BLOCK + src % BLOCK) * BLOCK + dst % BLOCK).reshape(-1)
    wvals = (torch.randn(half, n, generator=gen, device=dev) * std + mean_weight).reshape(-1)
    size = nb * S * BLOCK * BLOCK
    winner = torch.full((size,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, flat, torch.arange(flat.numel(), device=dev), "amax")
    w_blocks = torch.zeros(size, dtype=torch.float32, device=dev)
    hit = winner >= 0
    w_blocks[hit] = wvals[winner[hit]]
    j = torch.arange(nb, device=dev)
    band_src = (j[:, None] - torch.arange(n_band, device=dev)[None, :]) % nb
    src_idx = torch.cat([band_src, inv_perms.T], dim=1).to(torch.int32)
    w_in = _input_projection(gen, n_channels, n, n, min(r["input_fanout"], n),
                             r["input_weight"])
    return {"w_blocks": w_blocks.view(nb, S, BLOCK, BLOCK), "src_idx": src_idx,
            "w_in": w_in, "leak": _leak(r, n, n, dev)}


def make(config: dict, seed: int, device) -> dict:
    """Every array the configuration needs, from `seed`: the reservoir's
    (`dense` or `block_sparse`), the readout's w (D, K) and b (K,), and the
    scaler's mean and scale (D,)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    r = config["reservoir"]
    n_channels = config["frontend"]["n_filters"] * config["frontend"]["redundancy_factor"]
    mean_weight = config["assumed"]["mean_weight"]
    draw = block_sparse if r["layout"] == "block_sparse" else dense
    out = draw(r, n_channels, mean_weight, gen)
    no, k = r["num_output_neurons"], config["classes"]
    kinds = config["feature_keys"]
    d = len(kinds) * no
    typical = torch.tensor([config["scaler_typical"][f] for f in kinds], device=device)
    typical = typical.repeat_interleave(no, dim=0)                    # (D, 2)
    jitter = 0.5 + torch.rand(d, 2, generator=gen, device=device)
    out["scaler_mean"] = (typical[:, 0] * jitter[:, 0]).contiguous()
    out["scaler_scale"] = (typical[:, 1] * jitter[:, 1]).contiguous()
    out["readout_w"] = torch.randn(d, k, generator=gen, device=device) * config["readout_std"]
    out["readout_b"] = torch.zeros(k, device=device)
    return out
