"""Accuracy and the per-class precision/recall/F1 report
(port of lsm_tpu/readout/metrics.py); renders in sklearn's text layout,
identical to the reference package's."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    """(K, K) counts, rows = true class, cols = predicted class."""
    yt = np.asarray(y_true, np.int64)
    yp = np.asarray(y_pred, np.int64)
    cm = np.bincount(yt * num_classes + yp, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes).astype(np.float64)


@dataclasses.dataclass
class ClassificationReport:
    class_names: Sequence[str]
    precision: np.ndarray
    recall: np.ndarray
    f1: np.ndarray
    support: np.ndarray
    accuracy: float

    @property
    def macro_avg(self):
        return (
            float(self.precision.mean()),
            float(self.recall.mean()),
            float(self.f1.mean()),
        )

    @property
    def weighted_avg(self):
        w = self.support / max(self.support.sum(), 1)
        return (
            float((self.precision * w).sum()),
            float((self.recall * w).sum()),
            float((self.f1 * w).sum()),
        )

    def render(self) -> str:
        width = max(len(n) for n in self.class_names) + 2
        lines = [
            f"{'':>{width}}  precision    recall  f1-score   support",
            "",
        ]
        for i, name in enumerate(self.class_names):
            lines.append(
                f"{name:>{width}}  {self.precision[i]:9.2f} {self.recall[i]:9.2f}"
                f" {self.f1[i]:9.2f} {int(self.support[i]):9d}"
            )
        total = int(self.support.sum())
        mp, mr, mf = self.macro_avg
        wp, wr, wf = self.weighted_avg
        lines += [
            "",
            f"{'accuracy':>{width}}  {'':9} {'':9} {self.accuracy:9.2f} {total:9d}",
            f"{'macro avg':>{width}}  {mp:9.2f} {mr:9.2f} {mf:9.2f} {total:9d}",
            f"{'weighted avg':>{width}}  {wp:9.2f} {wr:9.2f} {wf:9.2f} {total:9d}",
        ]
        return "\n".join(lines)


def classification_report(
    y_true, y_pred, class_names: Sequence[str]
) -> ClassificationReport:
    k = len(class_names)
    yt = np.asarray(y_true)
    yp = np.asarray(y_pred)
    if yt.size:
        # Out-of-range labels must fail loudly, not vanish from the counts.
        for name, arr in (("y_true", yt), ("y_pred", yp)):
            if arr.min() < 0 or arr.max() >= k:
                raise ValueError(
                    f"{name} has labels outside [0, {k}) for "
                    f"{k} class_names: "
                    f"{np.unique(arr[(arr < 0) | (arr >= k)])[:4].tolist()}"
                )
    cm = confusion_matrix(yt, yp, k)
    tp = np.diag(cm)
    pred_tot = cm.sum(axis=0)
    true_tot = cm.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = np.where(pred_tot > 0, tp / pred_tot, 0.0)
        recall = np.where(true_tot > 0, tp / true_tot, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    acc = float(tp.sum() / max(cm.sum(), 1))
    return ClassificationReport(
        class_names=class_names,
        precision=precision,
        recall=recall,
        f1=f1,
        support=true_tot,
        accuracy=acc,
    )
