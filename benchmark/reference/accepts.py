"""The plain reference of accept counting over streamed probabilities
(microWakeWord's ``test.py`` false-accept scan): a sliding mean of the last
``window`` probabilities, and per cutoff a count of accepts, where an accept
fires when the mean exceeds the cutoff and no accept fired in the last
``ignore`` - 1 steps.  NumPy, float64 sums."""

from __future__ import annotations

import numpy as np

DEFAULT_CUTOFFS = np.arange(0, 1.01, 0.01)


def sliding_mean(probs: np.ndarray, window: int) -> np.ndarray:
    """[..., n] float32 -> [..., n - window + 1] float32: each mean of
    ``window`` consecutive probabilities, summed in float64."""
    p = np.asarray(probs, np.float64)
    if p.shape[-1] < window:
        return np.zeros(p.shape[:-1] + (0,), np.float32)
    total = sum(p[..., i:p.shape[-1] - window + 1 + i] for i in range(window))
    return (total / window).astype(np.float32)


def accept_counts(probs: np.ndarray, cutoffs, ignore: int) -> np.ndarray:
    """[..., n] -> [..., len(cutoffs)] int64 accept counts with the cooldown."""
    p = np.asarray(probs, np.float32)
    cut = np.asarray(cutoffs, np.float32)
    cooldown = np.full(p.shape[:-1] + cut.shape, ignore, np.int64)
    counts = np.zeros(cooldown.shape, np.int64)
    for t in range(p.shape[-1]):
        cooldown = np.maximum(cooldown - 1, 0)
        fire = (cooldown == 0) & (p[..., t, None] > cut)
        cooldown = np.where(fire, ignore, cooldown)
        counts += fire
    return counts
