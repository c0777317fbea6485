"""The multi-device training step: spikes -> features -> readout update
(port of lsm_tpu/parallel/train_step.py).

One step over a (data, model) mesh, each rank on its rows of the batch:
  - the tensor-parallel reservoir (parallel/sharded.py): W_rec's columns
    split over 'model', one spike gather a time step;
  - the features' standardization moments all-reduced over 'data', in two
    rounds (the global mean, then the centred second moment: the one-pass
    form cancels in float32 for large-mean spike-time features);
  - the readout's cross-entropy gradients all-reduced over 'data' and
    applied to the replicated readout by SGD.

The reservoir is fixed and random (the Liquid State Machine's model class);
training fits the readout on its features.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lsm_tpu_torch.models.reservoir import Reservoir
from lsm_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, all_reduce_sum
from lsm_tpu_torch.parallel.sharded import extract_features_model_sharded
from lsm_tpu_torch.readout.scaler import fit_scaler_from_moments


class ReadoutState(NamedTuple):
    w: torch.Tensor   # (D, K)
    b: torch.Tensor   # (K,)


def make_train_step(reservoir: Reservoir, feature_keys: Tuple[str, ...], num_classes: int,
                    mesh: Mesh, lr: float = 0.1, l2: float = 1e-3):
    """A (spikes, labels, readout) -> (loss, readout') step. spikes and
    labels are this rank's rows of the batch (`mesh.shard_batch`); the
    readout is replicated, and so are the loss and the new readout."""
    c_pad = reservoir.w_in.shape[0]
    n_data = mesh.shape[DATA_AXIS]

    def train_step(spikes: torch.Tensor, labels: torch.Tensor, readout: ReadoutState):
        if spikes.shape[1] > c_pad:
            raise ValueError(
                f"spike batch has {spikes.shape[1]} channels but the reservoir's input "
                f"projection takes at most {c_pad}: rebuild the reservoir with n_channels "
                "matching the dataset (incl. redundancy_factor)")
        feats = extract_features_model_sharded(reservoir, spikes, feature_keys, mesh)
        b_local = feats.shape[0]
        n_global = all_reduce_sum(torch.tensor(float(b_local), device=mesh.device), mesh)
        mean = all_reduce_sum(torch.sum(feats, dim=0), mesh) / n_global
        dev = feats - mean[None, :]
        sum_d2 = all_reduce_sum(torch.sum(dev * dev, dim=0), mesh)
        sc = fit_scaler_from_moments(torch.zeros_like(mean), sum_d2, n_global, shift=mean)
        feats_std = (feats - sc.mean) / sc.scale

        w = readout.w.detach().to(mesh.device).clone().requires_grad_(True)
        b = readout.b.detach().to(mesh.device).clone().requires_grad_(True)
        logits = feats_std @ w + b
        ce = torch.nn.functional.cross_entropy(logits, labels.to(mesh.device, torch.int64),
                                               reduction="sum")
        # The penalty splits evenly over the data shards, so the sum over
        # them is 0.5 * l2 * ||W||^2 once.
        loss_local = ce + 0.5 * l2 * torch.sum(w * w) / n_data
        gw, gb = torch.autograd.grad(loss_local, (w, b))
        loss = all_reduce_sum(loss_local.detach(), mesh) / n_global
        gw = all_reduce_sum(gw, mesh) / n_global
        gb = all_reduce_sum(gb, mesh) / n_global
        return loss, ReadoutState(w=(w - lr * gw).detach(), b=(b - lr * gb).detach())

    return train_step
