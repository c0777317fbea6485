"""The --check sanitizer (port of lsm_tpu/utils/checks.py).

lsm_tpu runs its single-device stages under `checkify` float checks, which
have no torch counterpart. The port checks each stage boundary instead,
with one device-side reduction each (a host sync per check; the default
paths stay unchecked):

- finite audio into the featurizer and a finite spectrogram before the
  encoder (`models/frontend.featurize_batch(check=...)`);
- spike trains strictly 0/1, on the featurizer's raw output, BEFORE the
  bit-pack: packing can only produce 0/1, so a check after it would be
  vacuous and a featurizer that emitted a 2 would be aliased into wrong
  bits instead of caught (lsm_tpu's `_check_spikes_host`);
- features finite and not constant after extraction (a dead reservoir
  makes every feature the same).

Every failure raises RuntimeError("--check failed in <context>: ..."),
lsm_tpu's text.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _fail(context: str, msg: str) -> None:
    raise RuntimeError(f"--check failed in {context}: {msg}")


def check_finite(x: torch.Tensor, context: str, what: str) -> None:
    """Raise if a floating tensor holds NaN or Inf (integer tensors pass)."""
    if x.dtype.is_floating_point:
        bad = int((~torch.isfinite(x)).sum())
        if bad:
            _fail(context, f"{bad} non-finite (NaN or Inf) {what}")


def check_spikes(spikes: torch.Tensor, context: str) -> None:
    """Raise unless every spike value is 0 or 1 (run it before the pack)."""
    bad = int(((spikes != 0) & (spikes != 1)).sum())
    if bad:
        _fail(context, f"{bad} spike values outside {{0, 1}}")


def validate_features(features: torch.Tensor) -> Tuple[bool, str]:
    """(ok, message) for an extracted feature matrix on any device:
    lsm_tpu's `validate_features_host` verdicts."""
    n_bad = int((~torch.isfinite(features)).sum())
    if n_bad:
        return False, f"{n_bad} non-finite feature values"
    if float(features.double().std(correction=0)) == 0.0:
        return False, "features are constant — reservoir produced no activity"
    return True, "ok"


def check_features(features: torch.Tensor, context: str) -> None:
    ok, msg = validate_features(features)
    if not ok:
        _fail(context, msg)
