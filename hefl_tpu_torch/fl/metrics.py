"""Classification metrics — the sklearn replacement.

The reference computes weighted precision/recall/F1/accuracy with
scikit-learn in notebook cell 3 (imports at
FLPyfhelin.py:15-16). Reimplemented over a confusion
matrix in numpy: same definitions (weighted = support-weighted average of
per-class scores, zero_division=0 semantics), no sklearn dependency.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int | None = None):
    k = num_classes or int(max(y_true.max(), y_pred.max())) + 1
    cm = np.zeros((k, k), np.int64)
    np.add.at(cm, (y_true.astype(int), y_pred.astype(int)), 1)
    return cm


def classification_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    """-> {accuracy, precision, recall, f1} with weighted averaging."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    cm = confusion_matrix(y_true, y_pred)
    support = cm.sum(axis=1)
    tp = np.diag(cm).astype(np.float64)
    pred_pos = cm.sum(axis=0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(pred_pos > 0, tp / pred_pos, 0.0)
        rec = np.where(support > 0, tp / support, 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    w = support / max(support.sum(), 1)
    return {
        "accuracy": float(tp.sum() / max(cm.sum(), 1)),
        "precision": float((prec * w).sum()),
        "recall": float((rec * w).sum()),
        "f1": float((f1 * w).sum()),
        "support": support.tolist(),
    }
