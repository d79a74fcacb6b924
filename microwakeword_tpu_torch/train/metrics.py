"""Validation metric math (port of train/metrics.py).

Device side: confusion counts over the 101-cutoff grid and the step's
threshold metrics with an exact rank AUC, as tensors on the batch's device
(no host sync inside the train step).  Host side: the reference's
checkpoint-selection curve math (train.py:104-161) in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

CUTOFFS = np.linspace(0.0, 1.0, 101)


def confusion_at_cutoffs(probs: torch.Tensor, labels: torch.Tensor, weights=None) -> dict:
    """tp/fp/tn/fn counts at each of the 101 cutoffs (Keras thresholds:
    positive iff prob > cutoff, the cutoffs in float32 as JAX holds them)."""
    probs = probs.reshape(-1)
    labels = labels.reshape(-1)
    cut = torch.as_tensor(CUTOFFS, dtype=torch.float32, device=probs.device)
    pred = probs[:, None] > cut[None, :]
    pos = labels[:, None] > 0.5
    w = torch.ones_like(probs)[:, None] if weights is None else weights.reshape(-1)[:, None]
    return {
        "tp": torch.sum(w * (pred & pos), dim=0),
        "fp": torch.sum(w * (pred & ~pos), dim=0),
        "fn": torch.sum(w * (~pred & pos), dim=0),
        "tn": torch.sum(w * (~pred & ~pos), dim=0),
    }


def binary_metrics(probs: torch.Tensor, labels: torch.Tensor) -> dict:
    """Threshold-0.5 accuracy/recall/precision, the exact (Mann-Whitney)
    AUC with ties ranked by a stable sort, as ``jnp.argsort`` ranks them, and
    the unweighted BCE loss; 0-dim tensors on the input's device."""
    probs = probs.reshape(-1)
    labels = labels.reshape(-1)
    pred = probs > 0.5
    pos = labels > 0.5
    tp = torch.sum(pred & pos)
    fp = torch.sum(pred & ~pos)
    fn = torch.sum(~pred & pos)
    tn = torch.sum(~pred & ~pos)
    n = probs.shape[0]
    order = torch.argsort(probs, stable=True)
    ranks = torch.empty_like(order).scatter(0, order, torch.arange(n, device=probs.device))
    n_pos = torch.sum(pos)
    n_neg = n - n_pos
    auc = (torch.sum(torch.where(pos, ranks, 0)) - n_pos * (n_pos - 1) / 2.0) / torch.clamp(
        n_pos * n_neg, min=1)
    p = torch.clamp(probs, 1e-7, 1 - 1e-7)
    loss = -torch.mean(torch.where(pos, torch.log(p), torch.log1p(-p)))
    return {
        "accuracy": (tp + tn) / max(n, 1),
        "recall": tp / torch.clamp(tp + fn, min=1),
        "precision": tp / torch.clamp(tp + fp, min=1),
        "auc": auc,
        "loss": loss,
    }


def validation_metrics(val_probs: np.ndarray, val_labels: np.ndarray,
                       ambient_probs: np.ndarray | None, ambient_duration_hours: float) -> dict:
    """Checkpoint-selection metrics (reference validate_nonstreaming,
    train.py:41-163).

    The reference accumulates tp/fn across both the validation and the
    ambient sets (its metric-accumulation hack, train.py:88-105); faph comes
    from the ambient set's false positives only.
    """
    val_probs = np.asarray(val_probs).reshape(-1)
    val_labels = np.asarray(val_labels).reshape(-1)
    base = {k: float(v) for k, v in binary_metrics(
        torch.as_tensor(val_probs, dtype=torch.float32),
        torch.as_tensor(val_labels, dtype=torch.float32)).items()}
    metrics = dict(base)
    metrics.update(recall_at_no_faph=0.0, cutoff_for_no_faph=0.0, ambient_false_positives=0.0,
                   ambient_false_positives_per_hour=0.0, average_viable_recall=0.0)
    if ambient_probs is None or len(ambient_probs) == 0:
        return metrics

    ambient_probs = np.asarray(ambient_probs).reshape(-1)
    cutoffs = CUTOFFS
    val_pos = val_labels > 0.5
    tp = ((val_probs[val_pos, None]) > cutoffs[None, :]).sum(axis=0)
    fn = val_pos.sum() - tp  # ambient windows are all negative: no tp/fn there
    ambient_fp = (ambient_probs[:, None] > cutoffs[None, :]).sum(axis=0)

    # loss and AUC over both sets (the reference's second evaluate call)
    all_probs = np.concatenate([val_probs, ambient_probs])
    all_labels = np.concatenate([val_labels, np.zeros_like(ambient_probs)])
    both = binary_metrics(torch.as_tensor(all_probs, dtype=torch.float32),
                          torch.as_tensor(all_labels, dtype=torch.float32))
    metrics["auc"] = float(both["auc"])
    metrics["loss"] = float(both["loss"])

    recall_at_cutoffs = tp / np.maximum(tp + fn, 1)
    faph_at_cutoffs = ambient_fp / max(ambient_duration_hours, 1e-12)

    recall_at_no_faph = 0.0
    target_faph_cutoff_probability = 1.0
    for index, cutoff in enumerate(cutoffs):
        if faph_at_cutoffs[index] == 0:
            target_faph_cutoff_probability = cutoff
            recall_at_no_faph = recall_at_cutoffs[index]
            break

    if faph_at_cutoffs[0] > 2:
        # linear interpolation of the recall at 2 faph (train.py:123-136)
        i = 1
        while faph_at_cutoffs[i] > 2:
            i += 1
        x0, y0 = faph_at_cutoffs[i - 1], recall_at_cutoffs[i - 1]
        x1, y1 = faph_at_cutoffs[i], recall_at_cutoffs[i]
        recall_at_2faph = (y0 * (x1 - 2.0) + y1 * (2.0 - x0)) / (x1 - x0)
        index_of_first_viable = i
    else:
        index_of_first_viable = 0
        recall_at_2faph = recall_at_cutoffs[0]

    x_coords = [2.0]
    y_coords = [recall_at_2faph]
    for index in range(index_of_first_viable, len(recall_at_cutoffs)):
        if faph_at_cutoffs[index] != x_coords[-1]:
            x_coords.append(faph_at_cutoffs[index])
            y_coords.append(recall_at_cutoffs[index])
    average_viable_recall = np.trapezoid(np.flip(y_coords), np.flip(x_coords)) / 2.0

    metrics["recall_at_no_faph"] = float(recall_at_no_faph)
    metrics["cutoff_for_no_faph"] = float(target_faph_cutoff_probability)
    metrics["ambient_false_positives"] = float(ambient_fp[50])
    metrics["ambient_false_positives_per_hour"] = float(faph_at_cutoffs[50])
    metrics["average_viable_recall"] = float(average_viable_recall)
    return metrics


def is_new_best(current_min: float, current_max: float, best_min: float, best_max: float,
                target_min: float) -> bool:
    """Two-step checkpoint selection (reference train.py:411-442): drive the
    minimization metric to its target, then maximize the maximization one."""
    return (
        (current_min <= target_min and (current_max > best_max or best_min > target_min))
        or (current_min > target_min and current_min < best_min)
        or (current_min == best_min and current_max > best_max)
    )
