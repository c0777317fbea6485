"""The tensor-parallel reservoir's rate (the port's counterpart of
tools/bench_tp.py).

Runs a --num-neurons reservoir (10,000 by default: BASELINE configs[3]'s
scale) through parallel/sharded.py's tensor-parallel scan,
`extract_features_model_sharded` (dense) or `..._sparse` (--sparse), on a
(data, model) mesh over the ranks of a multi-process launch (parallel/
mesh.py's env contract; --n-model 0 puts every rank on the model axis).
Each step gathers the ranks' spike slices. Launched as one process it
joins a one-rank group, so the TP code path runs at a model axis of 1.
Beside it, the same batch through the single-device path on rank 0 (B2
for a dense reservoir, B5 for a block-sparse one on the card).

    python -m lsm_tpu_torch.tools.bench_tp --sparse
    LSM_TPU_COORDINATOR=localhost:29500 LSM_TPU_NUM_PROCESSES=2 LSM_TPU_PROCESS_ID=<r> \\
        python -m lsm_tpu_torch.tools.bench_tp --sparse       # one per rank

Left out, with the reason: --pallas (on the port --sparse always has the
single-device comparison, which runs kernel B5 on one rank) and --bf16
(the TP scan runs f32 weights, lsm_tpu's default; the port has no bf16
twin of it).

The last line of stdout (rank 0) is one JSON object: tool, device, card,
ranks, mesh, neurons, sparse, batch, t, tp_s_min, tp_utt_per_s,
tp_utt_per_s_per_rank, single_s_min, single_utt_per_s and checksum (the
features' sum, the same on every mesh).
"""

from __future__ import annotations

import argparse
import socket
import sys

import numpy as np
import torch

from lsm_tpu_torch.tools import common


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _one_rank_group(device: torch.device) -> None:
    from lsm_tpu_torch.parallel.mesh import init_distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_distributed(f"localhost:{port}", 1, 0,
                     backend="nccl" if device.type == "cuda" else "gloo")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m lsm_tpu_torch.tools.bench_tp")
    p.add_argument("--num-neurons", type=int, default=10_000)
    p.add_argument("--num-outputs", type=int, default=400)
    p.add_argument("--n-channels", type=int, default=128)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--t", type=int, default=400)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--n-model", type=int, default=0, help="model-axis size (0 = every rank)")
    p.add_argument("--sparse", action="store_true", help="block-sparse reservoir")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from lsm_tpu_torch.config import FEATURE_SETS, ReservoirConfig
    from lsm_tpu_torch.device import resolve_device
    from lsm_tpu_torch.models import reservoir as res
    from lsm_tpu_torch.models import sparse as sp
    from lsm_tpu_torch.parallel import mesh as ml
    from lsm_tpu_torch.parallel.sharded import (
        extract_features_model_sharded, extract_features_model_sharded_sparse,
    )

    device = resolve_device(args.device)
    if not common.join_ranks():
        _one_rank_group(device)
    world = dist.get_world_size()
    n_model = args.n_model or world
    mesh = ml.make_mesh(world // n_model, n_model, device=device)
    device = mesh.device
    n = args.num_neurons
    if args.sparse:
        # The TP path shards destination blocks of 128 over the model axis.
        q = 128 * n_model
        if n % q:
            n = -(-n // q) * q
            log(f"--sparse: neurons {args.num_neurons} -> {n} (a multiple of {q})")
    cfg = ReservoirConfig(num_neurons=n, num_output_neurons=args.num_outputs,
                          small_world_k=int(0.10 * n * 2), mean_weight=0.002,
                          sparse=True if args.sparse else None)
    init = sp.init_reservoir_sparse if args.sparse else res.init_reservoir
    reservoir = init(cfg, args.n_channels, device=device)
    keys = tuple(FEATURE_SETS["original"])
    rng = np.random.default_rng(0)
    spikes = (rng.random((args.batch, args.n_channels, args.t)) < 0.05).astype(np.uint8)
    local = ml.shard_batch(spikes, mesh)
    tp = extract_features_model_sharded_sparse if args.sparse else extract_features_model_sharded

    def run_tp():
        return ml.host_local(tp(reservoir, local, keys, mesh), mesh)

    checksum = float(run_tp().double().sum())
    tp_walls = common.host_walls(run_tp, args.repeats, device, warmup=0,
                                 before=lambda: ml.barrier(mesh))
    rec = {"tool": "bench_tp", **common.identity(device), "ranks": world,
           "mesh": mesh.shape, "neurons": n, "sparse": args.sparse, "batch": args.batch,
           "t": args.t, "tp_s_min": min(tp_walls), "tp_utt_per_s": args.batch / min(tp_walls),
           "tp_utt_per_s_per_rank": args.batch / min(tp_walls) / world, "checksum": checksum}
    if ml.is_primary():
        full = torch.as_tensor(spikes).to(device)
        single = common.host_walls(lambda: res.extract_features(reservoir, full, keys),
                                   args.repeats, device)
        rec["single_s_min"] = min(single)
        rec["single_utt_per_s"] = args.batch / min(single)
        log(f"mesh {mesh.shape}, {n} neurons, B={args.batch}, T={args.t}: tensor-parallel "
            f"{rec['tp_utt_per_s']:.1f} utt/s ({min(tp_walls):.3f} s); single device "
            f"{rec['single_utt_per_s']:.1f} utt/s ({min(single):.3f} s); checksum "
            f"{checksum:.6e}")
    ml.barrier(mesh)
    if ml.is_primary():
        common.emit(rec)
    dist.destroy_process_group()
    return rec


if __name__ == "__main__":
    main()
