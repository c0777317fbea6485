"""Multinomial logistic readout fitted with L-BFGS
(port of lsm_tpu/readout/logistic.py).

Minimizes sklearn's lbfgs objective scaled by 1/(C*N):

    mean_i CE(softmax(x_i W + b), y_i) + 0.5 * (1/C) * ||W||^2 / N

with the intercept unpenalized, using torch.optim.LBFGS with a strong-Wolfe
line search and a 10-pair history (optax.lbfgs's default). The stopping rule
is the reference's: iterate while it < max_iter and the global L2 norm of
the gradient at the current point exceeds tol. `fit_ridge` is the
closed-form one-hot ridge alternative.

Data-parallel fits over a mesh (parallel/mesh.py): `fit_logistic_dp` runs
the same L-BFGS loop on every rank, each over its rows, with the loss and
gradient sums all-reduced over the data axis inside every evaluation, so
every rank takes the same steps; `fit_ridge_dp` all-reduces the Gram and
X^T Y blocks and every rank solves the same system. Padded rows carry
weight 0, so both optimize the unpadded objective.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from lsm_tpu_torch.utils.profiling import span


class LogisticReadout(nn.Module):
    """Weights (D, K) and intercept (K,) as buffers; forward gives logits."""

    def __init__(self, w, b):
        super().__init__()
        self.register_buffer("w", torch.as_tensor(w, dtype=torch.float32))
        self.register_buffer("b", torch.as_tensor(b, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def objective(w, b, x, y, l2: float) -> torch.Tensor:
    """Mean cross-entropy + 0.5 * l2 * ||W||^2 / N."""
    ce = nn.functional.cross_entropy(x @ w + b, y)
    return ce + 0.5 * l2 * torch.sum(w * w) / x.shape[0]


def weighted_objective(w, b, x, y, l2: float, weights, n_eff, shards: int = 1):
    """sum_i w_i CE_i / n_eff + 0.5 * l2 * ||W||^2 / n_eff / shards: with
    0/1 row weights and n_eff = sum w_i over all shards, summed over the
    `shards` data shards this is `objective` on the unpadded rows."""
    ce = nn.functional.cross_entropy(x @ w + b, y, reduction="none")
    return (torch.sum(ce * weights) + 0.5 * l2 * torch.sum(w * w) / shards) / n_eff


def fit_logistic(
    x: torch.Tensor,
    y: torch.Tensor,
    num_classes: int,
    l2_c: float = 1.0,
    max_iter: int = 1000,
    tol: float = 1e-5,
    weights: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[LogisticReadout, int]:
    """Full-batch L-BFGS fit on x's device. x (N, D) f32, y (N,) int64.
    Returns (readout, iterations used). With 0/1 row `weights` the padded
    rows (weight 0) drop out of the objective; with a mesh, x, y and
    weights are this rank's rows and every evaluation all-reduces the loss
    and gradients over the data axis (`fit_logistic_dp`)."""
    l2 = 1.0 / l2_c
    y = y.to(torch.int64)
    if weights is not None or mesh is not None:
        return _fit_weighted(x, y, num_classes, l2, max_iter, tol, weights, mesh)
    w = torch.zeros(x.shape[1], num_classes, device=x.device, requires_grad=True)
    b = torch.zeros(num_classes, device=x.device, requires_grad=True)
    # max_iter=1 per step(): the outer loop owns the stopping rule, and the
    # optimizer's own tolerances are off so they cannot stop it earlier.
    # max_eval bounds the line search (max_ls = max_eval - 1 = 25).
    opt = torch.optim.LBFGS(
        [w, b], lr=1.0, max_iter=1, max_eval=26, history_size=10,
        tolerance_grad=0.0, tolerance_change=0.0, line_search_fn="strong_wolfe",
    )

    def closure():
        opt.zero_grad()
        loss = objective(w, b, x, y, l2)
        loss.backward()
        return loss

    it = 0
    while it < max_iter:
        closure()
        gnorm = torch.sqrt(torch.sum(w.grad * w.grad) + torch.sum(b.grad * b.grad))
        if float(gnorm) <= tol:
            break
        opt.step(closure)
        it += 1
    return LogisticReadout(w.detach(), b.detach()), it


def _fit_weighted(x, y, num_classes, l2, max_iter, tol, weights, mesh):
    """fit_logistic's loop on `weighted_objective`, its sums all-reduced
    over the mesh's data axis where there is a mesh."""
    from lsm_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_sum

    if weights is None:
        weights = torch.ones(x.shape[0], device=x.device)
    weights = weights.to(torch.float32)
    shards = 1 if mesh is None else mesh.shape[DATA_AXIS]
    reduce = (lambda t: t) if mesh is None else (lambda t: all_reduce_sum(t, mesh))
    n_eff = reduce(torch.sum(weights))
    w = torch.zeros(x.shape[1], num_classes, device=x.device, requires_grad=True)
    b = torch.zeros(num_classes, device=x.device, requires_grad=True)
    opt = torch.optim.LBFGS(
        [w, b], lr=1.0, max_iter=1, max_eval=26, history_size=10,
        tolerance_grad=0.0, tolerance_change=0.0, line_search_fn="strong_wolfe",
    )

    def closure():
        opt.zero_grad()
        loss = weighted_objective(w, b, x, y, l2, weights, n_eff, shards)
        loss.backward()
        reduce(w.grad)
        reduce(b.grad)
        return reduce(loss.detach())

    it = 0
    while it < max_iter:
        closure()
        gnorm = torch.sqrt(torch.sum(w.grad * w.grad) + torch.sum(b.grad * b.grad))
        if float(gnorm) <= tol:
            break
        opt.step(closure)
        it += 1
    return LogisticReadout(w.detach(), b.detach()), it


def solve_normal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 b for the ridge's normal matrix a = G + alpha I, by LU with
    partial pivoting (torch.linalg.solve). lsm_tpu asks for Cholesky
    (jax.scipy.linalg.solve(assume_a="pos")); in float32 a Gram of tens of
    thousands of collinear feature rows can miss positive definiteness by
    more than alpha, where Cholesky fails and LU still solves."""
    return torch.linalg.solve(a, b)


def fit_ridge(x: torch.Tensor, y: torch.Tensor, num_classes: int,
              alpha: float = 1.0) -> LogisticReadout:
    """Closed-form one-hot ridge readout on x's device: the normal
    equations (Xc^T Xc + alpha I) W = Xc^T Yc on centered features and
    one-hot labels, b = y_mean - x_mean W."""
    d = x.shape[1]
    y1 = nn.functional.one_hot(y.to(torch.int64), num_classes).to(torch.float32)
    x_mean = x.mean(dim=0, keepdim=True)
    y_mean = y1.mean(dim=0, keepdim=True)
    xc, yc = x - x_mean, y1 - y_mean
    gram = xc.T @ xc + alpha * torch.eye(d, dtype=torch.float32, device=x.device)
    w = solve_normal(gram, xc.T @ yc)
    return LogisticReadout(w, (y_mean - x_mean @ w)[0])


def predict(readout: LogisticReadout, x: torch.Tensor) -> torch.Tensor:
    with span("lsm.readout"):
        return torch.argmax(readout(x), dim=-1)


# ---------------------------------------------------------------------------
# Data-parallel fits over a mesh
# ---------------------------------------------------------------------------

def _pad_for_mesh(x: np.ndarray, y: np.ndarray, n_shards: int):
    """Zero-pad the batch to a shard multiple; weight 0 marks padded rows."""
    from lsm_tpu_torch.parallel.mesh import pad_to_multiple

    x, n = pad_to_multiple(x, n_shards)
    y, _ = pad_to_multiple(y, n_shards)
    w = np.zeros(x.shape[0], np.float32)
    w[:n] = 1.0
    return x, y, w


def _shards(x, y, mesh):
    """This rank's rows of the padded (x, y, weights)."""
    from lsm_tpu_torch.parallel.mesh import DATA_AXIS, shard_host_array

    xp, yp, wp = _pad_for_mesh(np.asarray(x, np.float32), np.asarray(y, np.int64),
                               mesh.shape[DATA_AXIS])
    return (shard_host_array(xp, mesh), shard_host_array(yp, mesh),
            shard_host_array(wp, mesh))


def fit_logistic_dp(x, y, num_classes: int, mesh, l2_c: float = 1.0, max_iter: int = 1000,
                    tol: float = 1e-5) -> Tuple[LogisticReadout, int]:
    """`fit_logistic` with the rows sharded over the mesh's data axis. x, y
    are the FULL host arrays, identical on every rank; each rank fits on
    its rows, the loss and gradient sums all-reduced, and returns the same
    readout."""
    xs, ys, ws = _shards(x, y, mesh)
    return fit_logistic(xs, ys, num_classes, l2_c=l2_c, max_iter=max_iter, tol=tol,
                        weights=ws, mesh=mesh)


def fit_ridge_dp(x, y, num_classes: int, mesh, alpha: float = 1.0) -> LogisticReadout:
    """Data-parallel closed-form ridge: each rank's weighted centred Gram
    and X^T Y blocks, all-reduced over the data axis, and the same solve on
    every rank. x, y are the FULL host arrays, identical on every rank."""
    from lsm_tpu_torch.parallel.mesh import all_reduce_sum

    x_l, y_l, w_l = _shards(x, y, mesh)
    y1 = nn.functional.one_hot(y_l, num_classes).to(torch.float32)
    n = all_reduce_sum(torch.sum(w_l), mesh)
    x_mean = all_reduce_sum(torch.sum(x_l * w_l[:, None], dim=0), mesh)[None, :] / n
    y_mean = all_reduce_sum(torch.sum(y1 * w_l[:, None], dim=0), mesh)[None, :] / n
    xc = x_l - x_mean
    # The left factor carries the weight (w_i^2 = w_i), so padded rows add
    # nothing although centring makes them nonzero.
    xcw = xc * w_l[:, None]
    gram = all_reduce_sum(xcw.T @ xc, mesh)
    gram = gram + alpha * torch.eye(x_l.shape[1], dtype=torch.float32, device=x_l.device)
    xty = all_reduce_sum(xcw.T @ (y1 - y_mean), mesh)
    w = solve_normal(gram, xty)
    return LogisticReadout(w, (y_mean - x_mean @ w)[0])
