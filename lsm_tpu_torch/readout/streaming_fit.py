"""Constant-memory ridge readout fit from streamed feature batches
(port of lsm_tpu/readout/streaming_fit.py).

Stage 2+3 at corpus scale without ever holding the feature matrix: each
streamed batch of reservoir features updates O(D^2) sufficient statistics
on the device (a shifted Gram, a shifted feature-label cross term, the
scaler's moments and the class counts), and one closed-form solve at the
end reproduces `fit_ridge(scaler.transform(X_train), y_train)`
(readout/logistic.py) to float tolerance. The (D, D) Gram updates in place
(`addmm_`), as lsm_tpu's donated buffers do.

Numerics: the Gram accumulates around a fixed shift c (the first batch's
mean) instead of raw second moments, so the centering at the end
subtracts a small correction n (mu - c)(mu - c)^T rather than cancelling
two large numbers: reservoir statistics such as spike times have means far
from zero, where the raw form fails in float32. The scaler's mean is the
train mean, so the scaled features are exactly centered and the scaled
Gram and cross term are diagonal rescalings of the centered raw ones.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lsm_tpu_torch.readout.logistic import LogisticReadout, solve_normal
from lsm_tpu_torch.readout.scaler import Scaler, fit_scaler_from_moments


class RidgeAccumState(NamedTuple):
    """Sufficient statistics of a scaled, centered ridge fit over rows f_i
    with labels y_i, float32 on one device (lsm_tpu's fields; its 0/1 row
    weights mask padding, which the port's unpadded batches do not have).

    shift: (D,)   the fixed centering point c (the first batch's mean)
    gram:  (D, D) sum_i (f_i - c)(f_i - c)^T
    xte:   (D, K) sum_i (f_i - c) e_{y_i}^T
    s1:    (D,)   sum_i (f_i - c)
    s2:    (D,)   sum_i (f_i - c)^2
    cnt:   (K,)   per-class counts
    n:     ()     the row count
    """

    shift: torch.Tensor
    gram: torch.Tensor
    xte: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    cnt: torch.Tensor
    n: torch.Tensor


def init_ridge_accum(shift: torch.Tensor, num_classes: int) -> RidgeAccumState:
    """Empty statistics around `shift`, on its device."""
    d, dev = shift.shape[0], shift.device
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    return RidgeAccumState(shift=shift.to(torch.float32).clone(), gram=zeros(d, d),
                           xte=zeros(d, num_classes), s1=zeros(d), s2=zeros(d),
                           cnt=zeros(num_classes), n=zeros())


def update_ridge_accum(state: RidgeAccumState, feats: torch.Tensor,
                       labels: torch.Tensor) -> RidgeAccumState:
    """Fold one (B, D) feature batch into `state`, in place, and return it.
    Labels must lie in [0, K): the caller checks the range (torch's one_hot
    raises on a bad label where lsm_tpu's zeroes the row)."""
    k = state.xte.shape[1]
    y1 = torch.nn.functional.one_hot(labels.to(torch.int64), k).to(torch.float32)
    fc = feats.to(torch.float32) - state.shift[None, :]
    state.gram.addmm_(fc.T, fc)
    state.xte.addmm_(fc.T, y1)
    state.s1.add_(torch.sum(fc, dim=0))
    state.s2.add_(torch.sum(fc * fc, dim=0))
    state.cnt.add_(torch.sum(y1, dim=0))
    state.n.add_(float(fc.shape[0]))
    return state


def finalize_ridge(state: RidgeAccumState, alpha: float = 1.0) -> Tuple[LogisticReadout, Scaler]:
    """The closed-form solve (Z^T Z + alpha I) W = Z^T Yc on the scaled
    features. With mu the train mean, s the train std and d = mu - c:

        Z^T Z  = D^-1 (G - n d d^T) D^-1,   D = diag(s)
        Z^T Yc = D^-1 (A - d cnt^T)
        b      = y_mean            (the scaled features' mean is zero)

    d = s1 / n is cancellation free. Returns (readout, scaler)."""
    sc = fit_scaler_from_moments(state.s1, state.s2, state.n, shift=state.shift)
    delta = state.s1 / state.n
    gram_c = state.gram - state.n * torch.outer(delta, delta)
    xte_c = state.xte - torch.outer(delta, state.cnt)
    inv_s = 1.0 / sc.scale
    d = delta.shape[0]
    gram_z = gram_c * torch.outer(inv_s, inv_s) + alpha * torch.eye(
        d, dtype=torch.float32, device=delta.device)
    w = solve_normal(gram_z, xte_c * inv_s[:, None])
    return LogisticReadout(w, state.cnt / state.n), sc
