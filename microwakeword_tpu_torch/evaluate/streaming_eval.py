"""Streamed evaluation (port of evaluate/streaming_eval.py:24-96).

``streaming_model_roc`` and ``model_accuracy`` read the data store and wait
for the slice that ports it.
"""

from __future__ import annotations

import numpy as np
import torch

from microwakeword_tpu_torch.evaluate import roc as R


def _track_stream_probs(bundle, model, track) -> torch.Tensor:
    """Streaming per-step probabilities [T // stride] for one [T, 40] track.

    The JAX function pads tracks to a bucket of 512 steps so that XLA
    compiles once per bucket; eager PyTorch needs no bucket, and streaming is
    causal, so the steps it keeps are the same without the padding.
    """
    device = next(model.parameters()).device
    x = torch.as_tensor(track, dtype=torch.float32, device=device)
    t = x.shape[0] - x.shape[0] % bundle.stride
    if t <= 0:
        return torch.zeros((0,), device=device)
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
    (the reference's convention), summed over tracks.
    """
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
