"""Sharded execution paths (port of lsm_tpu/parallel/sharded.py): the
data-parallel stages and the tensor-parallel reservoir of scaled
configurations.

Every function here takes this rank's rows of the batch (`mesh.shard_batch`
of the full host batch) and returns this rank's rows of the result; the
caller gathers with `mesh.host_local`.

Data parallelism: the featurizer and the reservoir are independent per
utterance, so each rank runs the single-device path on its rows (kernels
B1 and B2, or B5, in every rank) with no collective. lsm_tpu's shard_map
does the same per device.

Model parallelism (lsm_tpu's XLA scan, not a kernel; here torch ops): the
reservoir's neurons split over the model axis. Each rank owns N/m columns
of W_rec (dense) or nb/m destination blocks (block-sparse) with their
input projection and leak, updates its slice of the membrane, and all
ranks of the model group gather the step's spike slices into the full
spike vector: one gather a step, which the next step's recurrent product
reads. Since every rank then holds the full vector, the statistics
accumulate on the gathered output neurons (the same values on each rank of
the group); the full-reservoir counts are gathered once at the end.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.ops.kernels import lif
from lsm_tpu_torch.ops.kernels.sparse_lif import BLOCK, sparse_drive
from lsm_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, gather_columns


def featurize_dp(audio: torch.Tensor, fcfg, mesh: Mesh, check: Optional[str] = None
                 ) -> torch.Tensor:
    """This rank's audio rows -> their (B_local, C, T) uint8 spikes: the
    single-device featurizer (kernel B1 on the card) on each rank."""
    from lsm_tpu_torch.models.frontend import featurize_batch

    return featurize_batch(audio.to(mesh.device), fcfg, check=check)


def extract_features_dp(reservoir, spikes: torch.Tensor, feature_keys: Tuple[str, ...],
                        mesh: Mesh) -> torch.Tensor:
    """This rank's spike rows -> their features: the single-device
    extraction (B2 for a dense reservoir, B5 for a block-sparse one) on
    each rank, weights replicated."""
    return res.extract_features(reservoir, spikes.to(mesh.device), feature_keys)


def data_parallel_extract(reservoir, spikes: torch.Tensor, feature_keys: Tuple[str, ...],
                          mesh: Mesh) -> torch.Tensor:
    """lsm_tpu's other name for `extract_features_dp`."""
    return extract_features_dp(reservoir, spikes, feature_keys, mesh)


def _weights(w: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """f32 weights (matmul_dtype None) or their bf16 rounding widened back
    to f32, which is what bf16 operands with f32 accumulation compute."""
    if matmul_dtype is None or matmul_dtype == torch.float32:
        return w.to(torch.float32)
    return w.to(matmul_dtype).to(torch.float32)


def _tp_stats(spikes, recurrent, w_in, leak_keep, reservoir, mesh):
    """The tensor-parallel scan of one rank's neuron slice: the statistics
    contract of `reservoir.simulate_batch`, all_counts gathered."""
    gather = lambda s: gather_columns(s, mesh, MODEL_AXIS)       # noqa: E731
    x = spikes.to(mesh.device, torch.uint8)
    stats, local_counts = lif.stats_scan(
        x, recurrent, w_in, leak_keep, threshold=reservoir.threshold,
        refractory=reservoir.refractory, burst_isi_max=reservoir.burst_isi_max,
        n_outputs=reservoir.n_outputs, n_win=reservoir.n_rate_windows, gather=gather)
    out = dict(zip(lif.STAT_KEYS, stats.unbind(0)))
    out["n_win_used"] = float(reservoir.n_rate_windows)
    out["all_counts"] = gather(local_counts)[:, :reservoir.n_neurons]
    return out


def _slice(n: int, mesh: Mesh) -> slice:
    m = mesh.shape[MODEL_AXIS]
    if n % m:
        raise ValueError(f"{n} columns do not divide over a model axis of {m}")
    j, per = mesh.index(MODEL_AXIS), n // m
    return slice(j * per, (j + 1) * per)


def simulate_model_sharded(reservoir: res.Reservoir, spikes: torch.Tensor, mesh: Mesh,
                           matmul_dtype=None) -> Dict[str, torch.Tensor]:
    """DP x TP dense reservoir: this rank's spike rows (B_local, C, T) ->
    their statistics (`reservoir.simulate_batch`'s contract), the same on
    every rank of the model group. W_rec's columns (destination neurons)
    split over the model axis; matmul_dtype None runs f32 weights (lsm_tpu's
    default here), torch.bfloat16 the kernels' bf16 rounding."""
    cols = _slice(reservoir.w_rec.shape[1], mesh)
    w_rec = _weights(reservoir.w_rec[:, cols], matmul_dtype)
    w_in = _weights(reservoir.w_in[:, cols], matmul_dtype)
    leak_keep = (1.0 - reservoir.leak[cols]).contiguous()
    return _tp_stats(spikes, lambda s: s @ w_rec, w_in, leak_keep, reservoir, mesh)


def simulate_model_sharded_sparse(reservoir, spikes: torch.Tensor, mesh: Mesh,
                                  matmul_dtype=None) -> Dict[str, torch.Tensor]:
    """DP x TP block-sparse reservoir: each rank owns nb/m destination
    blocks of (w_blocks, src_idx) with their input columns and leak;
    `sparse_drive` reads the gathered full spike vector, so src_idx's
    global source blocks stay valid per rank unchanged."""
    nb = reservoir.w_blocks.shape[0]
    blocks = _slice(nb, mesh)
    cols = slice(blocks.start * BLOCK, blocks.stop * BLOCK)
    wb = _weights(reservoir.w_blocks[blocks], matmul_dtype)
    idx = reservoir.src_idx[blocks].to(torch.int64)
    w_in = _weights(reservoir.w_in[:, cols], matmul_dtype)
    leak_keep = (1.0 - reservoir.leak[cols]).contiguous()
    return _tp_stats(spikes, lambda s: sparse_drive(s, wb, idx), w_in, leak_keep,
                     reservoir, mesh)


def extract_features_model_sharded(reservoir: res.Reservoir, spikes: torch.Tensor,
                                   feature_keys: Tuple[str, ...], mesh: Mesh,
                                   matmul_dtype=None) -> torch.Tensor:
    """This rank's spike rows -> their features (B_local, len(keys) *
    n_outputs) through `simulate_model_sharded`."""
    return res.features_from_stats(
        simulate_model_sharded(reservoir, spikes, mesh, matmul_dtype), feature_keys)


def extract_features_model_sharded_sparse(reservoir, spikes: torch.Tensor,
                                          feature_keys: Tuple[str, ...], mesh: Mesh,
                                          matmul_dtype=None) -> torch.Tensor:
    """This rank's spike rows -> their features through
    `simulate_model_sharded_sparse`."""
    return res.features_from_stats(
        simulate_model_sharded_sparse(reservoir, spikes, mesh, matmul_dtype), feature_keys)
