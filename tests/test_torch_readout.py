"""Parity of the port's readout (scaler, L-BFGS logistic, metrics) with the
JAX reference on the CPU.

The scaler is two float32 reductions and is held at rtol 1e-6 (with
atol 1e-7 for means near zero). The two
L-BFGS implementations take different paths to the same convex optimum, so
they are compared by what they minimize (the port's final objective may not
exceed the reference's by more than 1e-4 relative) and by what they predict
(>= 98 % of test predictions agree), not by iterates or iteration counts.

The ridge solves: the port solves the normal equations by LU, lsm_tpu by
Cholesky (`assume_a="pos"`). On a well-conditioned Gram the weights agree
within 1e-4 of their largest magnitude (the two factorizations round
differently in float32). On collinear float32 rows whose Gram is not
positive definite to alpha = 1, lsm_tpu returns all-NaN weights without an
error; the port returns finite weights whose backward error
||A W - B|| / (||A|| ||W|| + ||B||) on the matrix it solved stays below
1e-5: a divergence the reference causes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lsm_tpu.readout import logistic as jlog
from lsm_tpu.readout import metrics as jmet
from lsm_tpu.readout import scaler as jsc
from lsm_tpu.readout import streaming_fit as jsf

from lsm_tpu_torch import convert
from lsm_tpu_torch.readout import logistic as tlog
from lsm_tpu_torch.readout import metrics as tmet
from lsm_tpu_torch.readout import scaler as tsc
from lsm_tpu_torch.readout import streaming_fit as tsf

# Under pytest-xdist several workers share a few cores; torch's intra-op
# thread pools would contend (the tiny ops here run ~10x slower so).
torch.set_num_threads(1)

K = 6


@pytest.fixture(scope="module")
def features():
    """Reservoir-like features: counts and spike times with large means and
    small spreads (the case the two-pass scaler exists for), class-dependent
    shifts so the task is learnable but not separable."""
    rng = np.random.default_rng(17)
    n, d = 360, 240
    y = np.repeat(np.arange(K), n // K).astype(np.int32)
    centers = rng.standard_normal((K, d)) * 0.6
    x = centers[y] + rng.standard_normal((n, d))
    x[:, : d // 2] = 150.0 + 0.05 * x[:, : d // 2]
    x[:, -3:] = 7.0                                          # zero variance
    perm = rng.permutation(n)
    return x[perm].astype(np.float32), y[perm]


@pytest.fixture(scope="module")
def jax_fit(features):
    x, y = features
    st = jsc.fit_scaler(jnp.asarray(x[:288]))
    xs = np.array(jsc.transform(st, jnp.asarray(x)))
    params, iters = jlog.fit_logistic(
        jnp.asarray(xs[:288]), jnp.asarray(y[:288]), num_classes=K, tol=1e-4
    )
    return st, xs, params, int(iters)


def _objective64(w, b, x, y, l2=1.0):
    z = x.astype(np.float64) @ np.asarray(w, np.float64) + np.asarray(b, np.float64)
    z -= z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return -logp[np.arange(len(y)), y].mean() + 0.5 * l2 * np.sum(np.asarray(w, np.float64) ** 2) / len(y)


def test_scaler_matches(features, jax_fit):
    x, _ = features
    st, xs, _, _ = jax_fit
    port = tsc.fit_scaler(torch.as_tensor(x[:288]))
    # atol: a near-zero mean carries the f32 summation-order error of its
    # 288-term sum (~1e-8 here), which no relative tolerance covers.
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(st.mean), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.scale.numpy(), np.asarray(st.scale), rtol=1e-6)
    assert (port.scale.numpy()[-3:] == 1.0).all()
    # transform() of the same state: (x - mean) / scale, one rounding each.
    # (Transforms of the two fitted states are not compared: a 1-ulp mean
    # difference at 150 over a 0.05 spread is a 3e-4 shift after scaling.)
    conv = convert.scaler(st)
    np.testing.assert_allclose(conv(torch.as_tensor(x)).numpy(), xs, rtol=1e-6, atol=1e-6)


def test_logistic_objective_and_predictions(features, jax_fit):
    _, y = features
    _, xs, jparams, jiters = jax_fit
    readout, iters = tlog.fit_logistic(
        torch.as_tensor(xs[:288]), torch.as_tensor(y[:288]), num_classes=K, tol=1e-4
    )
    f_jax = _objective64(jparams.w, jparams.b, xs[:288], y[:288])
    f_port = _objective64(readout.w.numpy(), readout.b.numpy(), xs[:288], y[:288])
    print(f"objective jax {f_jax:.8f} ({jiters} it) port {f_port:.8f} ({iters} it)")
    assert f_port <= f_jax * (1 + 1e-4)
    assert 0 < iters < 1000
    p_jax = np.asarray(jlog.predict(jparams, jnp.asarray(xs[288:])))
    p_port = tlog.predict(readout, torch.as_tensor(xs[288:])).numpy()
    assert (p_jax == p_port).mean() >= 0.98
    # The converted reference readout predicts as the reference does.
    p_conv = tlog.predict(convert.readout(jparams), torch.as_tensor(xs[288:])).numpy()
    np.testing.assert_array_equal(p_conv, p_jax)


def test_logistic_stopping_rule():
    """max_iter bounds the iterations; a zero-gradient start stops at once."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((40, 5)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 3, 40))
    _, iters = tlog.fit_logistic(x, y, 3, max_iter=3, tol=0.0)
    assert iters == 3
    _, iters = tlog.fit_logistic(torch.zeros(40, 5), torch.zeros(40, dtype=torch.int64), 1)
    assert iters == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_classification_report_render_identical(seed):
    rng = np.random.default_rng(seed)
    names = ["yes", "no", "up", "visual", "backward"]
    y_true = rng.integers(0, 5, 97)
    y_pred = np.where(rng.random(97) < 0.7, y_true, rng.integers(0, 5, 97))
    if seed:
        y_pred[y_pred == 3] = 2                              # a never-predicted class
    ref = jmet.classification_report(y_true, y_pred, names)
    out = tmet.classification_report(y_true, y_pred, names)
    assert out.render() == ref.render()
    assert out.accuracy == ref.accuracy
    with pytest.raises(ValueError):
        tmet.classification_report(y_true, np.full(97, 5), names)


# ---- the ridge solves: LU in the port, Cholesky in lsm_tpu ----------------

RIDGE_REL = 1e-4       # LU against Cholesky on a well-conditioned float32 Gram
BACKWARD_ERR = 1e-5    # the port's LU on the matrix it solved


def _well_conditioned():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    return x, (np.arange(300) % K).astype(np.int32)


def _collinear_rank8():
    """400 rows of 64 float32 features that are combinations of 8, at a
    scale of 3e3: the centered Gram is rank 8 and its float32 rounding
    leaves eigenvalues far below -alpha."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((400, 8)).astype(np.float32)
    mix = rng.standard_normal((8, 64)).astype(np.float32)
    x = ((base @ mix) * np.float32(3e3)).astype(np.float32)
    return x, (np.arange(400) % K).astype(np.int32)


def _collinear_shifted():
    """4096 rows of 16 features that are one signal at 16 scales (0.01 to
    0.02) around 50, the first row at -50 and alone in the first batch.
    The streaming accumulator centers on the first batch's mean, so its
    float32 Gram carries n (mu - c)^2 / s^2 ~ n^2 times the rounding of the
    scaled one: the scaled Gram is no longer positive definite to
    alpha = 1."""
    rng = np.random.default_rng(1)
    t = rng.standard_normal(4096).astype(np.float32)
    k = (1.0 + rng.random(16)).astype(np.float32)
    x = (t[:, None] * k[None, :] * np.float32(0.01) + np.float32(50.0)).astype(np.float32)
    x[0] = np.float32(-50.0)
    return x, (np.arange(4096) % K).astype(np.int32)


def _reference_accum(x, y, first=128, batch=128):
    """lsm_tpu's ridge accumulator over x in a first batch of `first` rows,
    then batches of `batch`, shifted by the first batch's mean."""
    st = jsf.init_ridge_accum(jnp.asarray(x[:first].mean(axis=0)), K)
    for s in [0, *range(first, x.shape[0], batch)]:
        e = first if s == 0 else s + batch
        st = jsf.update_ridge_accum(st, jnp.asarray(x[s:e]), jnp.asarray(y[s:e]),
                                    jnp.ones(x[s:e].shape[0], jnp.float32))
    return st


def _port_solve(monkeypatch, module, fn, *args, **kw):
    """Run the port's fit with its solve recorded: (result, A, B, W)."""
    seen, lu = {}, tlog.solve_normal

    def solve(a, b):
        w = lu(a, b)
        seen.update(a=a.double(), b=b.double(), w=w.double())
        return w

    monkeypatch.setattr(module, "solve_normal", solve)
    out = fn(*args, **kw)
    return out, seen["a"], seen["b"], seen["w"]


def _backward_error(a, b, w) -> float:
    r = torch.linalg.matrix_norm(a @ w - b)
    return float(r / (torch.linalg.matrix_norm(a) * torch.linalg.matrix_norm(w)
                      + torch.linalg.matrix_norm(b)))


@pytest.mark.parametrize("fit", ["fit_ridge", "finalize_ridge"])
def test_ridge_solves_agree_on_a_well_conditioned_gram(fit, monkeypatch):
    x, y = _well_conditioned()
    if fit == "fit_ridge":
        ref = jlog.fit_ridge(jnp.asarray(x), jnp.asarray(y), K, alpha=1.0)
        port, a, b, w = _port_solve(monkeypatch, tlog, tlog.fit_ridge,
                                    torch.as_tensor(x), torch.as_tensor(y), K, alpha=1.0)
    else:
        st = _reference_accum(x, y)
        ref, _ = jsf.finalize_ridge(st, alpha=1.0)
        (port, _), a, b, w = _port_solve(monkeypatch, tsf, tsf.finalize_ridge,
                                         convert.ridge_accum(st), alpha=1.0)
    rw, rb = np.asarray(ref.w), np.asarray(ref.b)
    assert np.isfinite(rw).all()
    np.testing.assert_allclose(port.w.numpy(), rw, rtol=0, atol=RIDGE_REL * np.abs(rw).max())
    np.testing.assert_allclose(port.b.numpy(), rb, rtol=0, atol=RIDGE_REL * max(np.abs(rb).max(), 1.0))
    assert _backward_error(a, b, w) < BACKWARD_ERR


@pytest.mark.parametrize("fit", ["fit_ridge", "finalize_ridge"])
def test_ridge_on_a_gram_not_positive_definite(fit, monkeypatch):
    """lsm_tpu's Cholesky solve gives all-NaN weights and raises nothing;
    the port's LU gives finite weights with a small backward error."""
    if fit == "fit_ridge":
        x, y = _collinear_rank8()
        ref = jlog.fit_ridge(jnp.asarray(x), jnp.asarray(y), K, alpha=1.0)
        port, a, b, w = _port_solve(monkeypatch, tlog, tlog.fit_ridge,
                                    torch.as_tensor(x), torch.as_tensor(y), K, alpha=1.0)
    else:
        x, y = _collinear_shifted()
        st = _reference_accum(x, y, first=1)
        ref, _ = jsf.finalize_ridge(st, alpha=1.0)
        (port, _), a, b, w = _port_solve(monkeypatch, tsf, tsf.finalize_ridge,
                                         convert.ridge_accum(st), alpha=1.0)
    # The matrix both packages solve is not positive definite.
    assert float(torch.linalg.eigvalsh(a).min()) < 0.0
    assert np.isnan(np.asarray(ref.w)).all()
    assert torch.isfinite(port.w).all() and torch.isfinite(port.b).all()
    assert _backward_error(a, b, w) < BACKWARD_ERR
