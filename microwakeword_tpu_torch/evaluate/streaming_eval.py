"""Streamed evaluation (port of evaluate/streaming_eval.py).

The streamed ambient ROC (``streaming_model_roc``) and the test-set accuracy
(``model_accuracy``) over the data store's evaluation sets, one streaming
scan per track.  Over a mesh the ROC's tracks are scanned as the JAX
package scans them there: bucketed and stacked, each rank scanning its
block of every stack (``parallel/eval.py``), so that every rank holds every
track's probabilities and returns the same global curve.  A ``stream_fn``
over a mesh scores tracks ``[r::D]`` on rank r, and the per-cutoff accept
counts, hours and detections are summed over the ranks (the JAX package's
``_global_sum``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from microwakeword_tpu_torch.evaluate import roc as R
from microwakeword_tpu_torch.trace import span


def _track_stream_probs(bundle, model, track, stream_fn=None) -> torch.Tensor:
    """Streaming per-step probabilities [T // stride] for one [T, 40] track.

    The JAX function pads tracks to a bucket of 512 steps so that XLA
    compiles once per bucket; eager PyTorch needs no bucket, and streaming is
    causal, so the steps it keeps are the same without the padding.
    ``stream_fn(model, x [1, T, F] float32 array)``, where given, scores the
    exact track instead (an int8 runner, say).
    """
    device = next(model.parameters()).device
    t = track.shape[0] - track.shape[0] % bundle.stride
    if t <= 0:
        return torch.zeros((0,), device=device)
    if stream_fn is not None:
        probs = stream_fn(model, np.asarray(track[None, :t], np.float32))
        return torch.as_tensor(np.asarray(probs)).reshape(-1)
    x = torch.as_tensor(track, dtype=torch.float32, device=device)
    return bundle.stream_scan(model, x[None, :t]).reshape(-1)


def ambient_accept_counts(
    probs_list,
    cutoffs,
    ignore_slices_after_accept: int,
    sliding_window_length: int = 5,
    stride: int = 1,
    step_s: float = 0.01,
):
    """Per-cutoff cooldown accept counts over prob tracks; returns
    ([len(cutoffs)] counts, hours).

    Each item of ``probs_list`` is one track [T] or a batch of equal-length
    tracks [B, T].  Hours are the duration of the moving-averaged sequences
    (the reference's convention), summed over tracks.  Under a torch
    profiler the call is an ``accept.counts`` span (``trace.py``).
    """
    with span("accept.counts"):
        total = np.zeros(len(cutoffs))
        hours = 0.0
        for probs in probs_list:
            ma = R.moving_average(probs, sliding_window_length)
            if ma.shape[-1]:
                hours += ma.numel() * stride * step_s / 3600.0
                counts = R.count_accepts(ma, cutoffs, ignore_slices_after_accept)
                total += counts.reshape(-1, len(cutoffs)).sum(dim=0).cpu().numpy()
        return total, hours


def positive_detection_counts(max_probs, cutoffs):
    """[len(cutoffs)] counts of positives whose windowed max prob exceeds
    each cutoff, and the number of positives."""
    max_probs = np.asarray(max_probs, np.float64).reshape(-1)
    detected = (max_probs[:, None] > np.asarray(cutoffs)[None, :]).sum(axis=0)
    return detected.astype(np.float64), len(max_probs)


def _global_sum(values: np.ndarray, mesh) -> np.ndarray:
    """``values`` summed over the mesh's ranks (as they are without one)."""
    if mesh is None:
        return values
    return mesh.all_reduce(torch.as_tensor(values, dtype=torch.float64,
                                           device=mesh.device)).cpu().numpy()


def streaming_model_roc(bundle, model, feature_handler, config: dict, folder: str | None = None,
                        data_set: str = "testing", ambient_set: str = "testing_ambient",
                        sliding_window_length: int = 5, ignore_slices_after_accept: int = 25,
                        accuracy_name: str = "streaming_roc.txt", stream_fn=None,
                        mesh=None) -> dict:
    """False-accepts-per-hour vs false-rejection ROC of the streaming model
    (reference tflite_streaming_model_roc, test.py:293-403).

    Returns a dict with the AUC, the curve's coordinates, faph and the
    cutoff table.  ``stream_fn(model, x)`` can replace the source of the
    probabilities (an int8 runner, say) under the same metric math.  With a
    ``mesh`` (parallel/mesh.py) each rank scans its share of the tracks and
    every rank returns the global curve (module docstring); rank 0 writes
    ``folder``.
    """
    rank, size = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    batched = mesh is not None and stream_fn is None
    sum_mesh = None if batched else mesh  # the ranks' counts to sum, where they differ

    def track_probs(tracks):
        """The probabilities of the tracks this rank counts."""
        if batched:
            from microwakeword_tpu_torch.parallel.eval import batched_track_probs

            return batched_track_probs(bundle, model, list(tracks), mesh)
        return [_track_stream_probs(bundle, model, t, stream_fn) for t in tracks[rank::size]]

    ambient_tracks, _, _ = feature_handler.get_data(
        ambient_set, batch_size=config.get("batch_size", 128),
        features_length=config["spectrogram_length"], truncation_strategy="none")
    cutoffs = R.DEFAULT_CUTOFFS
    local_counts, local_hours = ambient_accept_counts(
        track_probs(ambient_tracks), cutoffs, ignore_slices_after_accept, sliding_window_length,
        stride=config.get("stride", 1), step_s=config.get("window_step_ms", 10) / 1000.0)
    combined = _global_sum(np.concatenate([local_counts, [local_hours]]), sum_mesh)
    accept_counts, hours = combined[:-1], float(combined[-1])
    faph = accept_counts / hours if hours > 0 else np.zeros(len(cutoffs))

    test_x, test_y, _ = feature_handler.get_data(
        data_set, batch_size=config.get("batch_size", 128),
        features_length=config["spectrogram_length"], truncation_strategy="none")
    positives = [s for s, label in zip(test_x, test_y) if label > 0.5]
    positive_max_probs = []
    for probs in track_probs(positives):
        ma = R.moving_average(probs[ignore_slices_after_accept:], sliding_window_length)
        if ma.numel():
            positive_max_probs.append(float(ma.max()))

    detected, n_local = positive_detection_counts(positive_max_probs, cutoffs)
    combined = _global_sum(np.concatenate([detected, [float(n_local)]]), sum_mesh)
    detected, n_pos = combined[:-1], int(combined[-1])
    fnr = 1.0 - detected / n_pos if n_pos > 0 else np.ones(len(cutoffs))

    xs, ys, cs = R.generate_roc_curve(faph, fnr, cutoffs)
    auc = R.roc_auc(xs, ys)
    result = {
        "auc": auc,
        "x_faph": xs,
        "y_frr": ys,
        "cutoffs": cs,
        "faph_at_cutoffs": faph,
        "frr_at_cutoffs": np.asarray(fnr),
        "positive_count": int(n_pos),
    }
    if folder and rank == 0:
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, accuracy_name), "w") as f:
            f.write(f"AUC {auc:.5f}\n")
            for i in range(len(xs)):
                f.write(f"Cutoff {cs[i]:.2f}: frr={ys[i]:.4f}; faph={xs[i]:.3f}\n")
    return result


def model_accuracy(bundle, model, feature_handler, config: dict, data_set: str = "testing",
                   folder: str | None = None, accuracy_name: str = "model_accuracy.txt",
                   use_streaming: bool = False) -> dict:
    """Accuracy metrics on a test set (reference tf_model_accuracy /
    tflite_model_accuracy semantics, test.py:207-290, 406-517).

    Non-ambient sets: the last window's prediction at threshold 0.5.
    Ambient sets ('none' truncation): 0.5-crossing false accepts with a
    refractory window of spectrogram_length_final_layer slices.
    """
    truncation = "none" if data_set.endswith("ambient") else "truncate_start"
    x, y, _ = feature_handler.get_data(
        data_set, batch_size=config.get("batch_size", 128),
        features_length=config["spectrogram_length"], truncation_strategy=truncation)
    tp = tn = fp = fn = 0
    if truncation != "none":
        if use_streaming:
            preds = []
            for spec in x:
                probs = _track_stream_probs(bundle, model, spec)
                preds.append(len(probs) > 0 and bool(probs[-1] > 0.5))
            preds = np.asarray(preds, dtype=bool)
        else:
            device = next(model.parameters()).device
            with torch.inference_mode():
                probs = bundle.forward(model, torch.as_tensor(x, device=device)).reshape(-1)
            preds = probs.cpu().numpy() > 0.5
        pos = y > 0.5
        tp = int(np.sum(preds & pos))
        tn = int(np.sum(~preds & ~pos))
        fp = int(np.sum(preds & ~pos))
        fn = int(np.sum(~preds & pos))
    else:
        refractory = int(config.get("spectrogram_length_final_layer", 0))
        for spec in x:
            probs = _track_stream_probs(bundle, model, spec)
            if len(probs):
                fp += int(R.count_crossings(probs, 0.5, refractory))

    count = tp + tn + fp + fn
    metrics = {
        "accuracy": (tp + tn) / count if count else float("nan"),
        "recall": tp / (tp + fn) if (tp + fn) else float("nan"),
        "precision": tp / (tp + fp) if (tp + fp) else float("nan"),
        "false_positive_rate": fp / (fp + tn) if (fp + tn) else float("nan"),
        "false_negative_rate": fn / (tp + fn) if (tp + fn) else float("nan"),
        "count": count,
        "false_positives": fp,
    }
    if data_set.endswith("ambient"):
        hours = feature_handler.get_mode_duration(data_set) / 3600.0
        metrics["false_accepts_per_hour"] = fp / hours if hours else float("nan")
    if folder:
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, accuracy_name), "w") as f:
            f.write(repr(metrics))
    return metrics
