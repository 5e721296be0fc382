"""Disentanglement + classification metrics (the port's copy of
medvae_tpu/analysis/disentanglement.py, which imports no JAX).

Parity: reference compute_disentanglement_metrics / compute_mig /
compute_beta_vae_metric / compute_classification_metrics
(src/utils/metrics.py:138-262): MIG via per-(latent, factor) mutual information
with the gap between the top-2 informative latents, a linear-probe "β-VAE
metric" (R² of a linear regressor from latents to each factor), and
accuracy/F1/precision/recall for multiclass/multilabel heads. sklearn-backed
host computations on already-extracted latents (small arrays)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def compute_mig(latents: np.ndarray, factors: np.ndarray) -> float:
    """Mutual Information Gap: mean over factors of
    (max MI − 2nd max MI)/max MI across latent dims (reference :169-191)."""
    from sklearn.feature_selection import mutual_info_regression

    latents = np.asarray(latents, np.float64)
    factors = np.asarray(factors, np.float64)
    if factors.ndim == 1:
        factors = factors[:, None]
    gaps = []
    for f in range(factors.shape[1]):
        mi = np.array(
            [
                mutual_info_regression(
                    latents[:, z : z + 1], factors[:, f], random_state=0
                )[0]
                for z in range(latents.shape[1])
            ]
        )
        if len(mi) > 1 and mi.max() > 0:
            order = np.argsort(mi)
            gaps.append((mi[order[-1]] - mi[order[-2]]) / mi[order[-1]])
        else:
            gaps.append(0.0)
    return float(np.mean(gaps))


def compute_beta_vae_metric(latents: np.ndarray, factors: np.ndarray) -> float:
    """Linear-probe R² from latents to each factor (reference :194-211)."""
    from sklearn.linear_model import LinearRegression
    from sklearn.model_selection import train_test_split

    latents = np.asarray(latents, np.float64)
    factors = np.asarray(factors, np.float64)
    if factors.ndim == 1:
        factors = factors[:, None]
    scores = []
    for f in range(factors.shape[1]):
        x_tr, x_te, y_tr, y_te = train_test_split(
            latents, factors[:, f], test_size=0.2, random_state=42
        )
        model = LinearRegression().fit(x_tr, y_tr)
        scores.append(model.score(x_te, y_te))
    return float(np.mean(scores))


def compute_disentanglement_metrics(
    latents: np.ndarray, factors: np.ndarray
) -> Dict[str, float]:
    latents = np.asarray(latents)
    if latents.ndim > 2:
        latents = latents.reshape(len(latents), -1)
    return {
        "mig": compute_mig(latents, factors),
        "beta_vae_metric": compute_beta_vae_metric(latents, factors),
    }


def compute_classification_metrics(
    predictions: np.ndarray,
    targets: np.ndarray,
    num_classes: int,
    task_type: str = "multiclass",
) -> Dict[str, float]:
    """accuracy/F1/precision/recall (reference :214-262). `predictions` are
    logits; multilabel thresholds sigmoid at 0.5, multiclass argmaxes."""
    from sklearn.metrics import (
        accuracy_score,
        f1_score,
        precision_score,
        recall_score,
    )

    predictions = np.asarray(predictions, np.float64)
    targets = np.asarray(targets)

    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    if task_type == "multilabel":
        preds = sigmoid(predictions) > 0.5
        return {
            "accuracy": float(accuracy_score(targets, preds)),
            "f1_macro": float(f1_score(targets, preds, average="macro",
                                       zero_division=0)),
            "f1_micro": float(f1_score(targets, preds, average="micro",
                                       zero_division=0)),
            "precision": float(precision_score(targets, preds, average="macro",
                                               zero_division=0)),
            "recall": float(recall_score(targets, preds, average="macro",
                                         zero_division=0)),
        }
    if predictions.ndim > 1 and predictions.shape[1] > 1:
        preds = predictions.argmax(axis=1)
    else:
        preds = (sigmoid(predictions) > 0.5).astype(np.int64).squeeze()
    avg = "binary" if num_classes == 2 else "macro"
    return {
        "accuracy": float(accuracy_score(targets, preds)),
        "f1": float(f1_score(targets, preds, average=avg, zero_division=0)),
        "precision": float(precision_score(targets, preds, average=avg,
                                           zero_division=0)),
        "recall": float(recall_score(targets, preds, average=avg,
                                     zero_division=0)),
    }
