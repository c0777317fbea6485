"""Multinomial logistic readout fitted with L-BFGS
(port of lsm_tpu/readout/logistic.py).

Minimizes sklearn's lbfgs objective scaled by 1/(C*N):

    mean_i CE(softmax(x_i W + b), y_i) + 0.5 * (1/C) * ||W||^2 / N

with the intercept unpenalized, using torch.optim.LBFGS with a strong-Wolfe
line search and a 10-pair history (optax.lbfgs's default). The stopping rule
is the reference's: iterate while it < max_iter and the global L2 norm of
the gradient at the current point exceeds tol. `fit_ridge` is the
closed-form one-hot ridge alternative.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


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


def fit_logistic(
    x: torch.Tensor,
    y: torch.Tensor,
    num_classes: int,
    l2_c: float = 1.0,
    max_iter: int = 1000,
    tol: float = 1e-5,
) -> Tuple[LogisticReadout, int]:
    """Full-batch L-BFGS fit on x's device. x (N, D) f32, y (N,) int64.
    Returns (readout, iterations used)."""
    l2 = 1.0 / l2_c
    y = y.to(torch.int64)
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
    return torch.argmax(readout(x), dim=-1)
