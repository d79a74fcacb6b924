"""ROC / false-accepts-per-hour math (port of evaluate/roc.py).

The counting functions take tensors (or arrays) on any device and run there;
``count_accepts`` is vectorised over cutoffs and over any leading batch of
tracks: on a CUDA tensor one kernel (``evaluate/accepts_kernel.py``), on the
CPU a loop over time for the cooldown.  ``generate_roc_curve`` and
``roc_auc`` are NumPy, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from microwakeword_tpu_torch.evaluate import accepts_kernel

DEFAULT_CUTOFFS = np.arange(0, 1.01, 0.01)


def _as_tensor(x, dtype) -> torch.Tensor:
    return x.to(dtype) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), dtype=dtype)


def moving_average(probs, window: int = 5) -> torch.Tensor:
    """Sliding-window mean over the last axis: [..., n] -> [..., n - window + 1]
    float32, each window summed on its own in float64, as
    ``sliding_window_view(...).mean(-1)`` (reference test.py:337-341).  The
    JAX package's difference of running sums (roc.py:20-27) loses a window's
    tiny probabilities beside the stream's sum so far, and cutoff 0 then
    misses accepts over saturated probabilities."""
    p = _as_tensor(probs, torch.float64)
    if p.dim() == 0:
        p = p.reshape(1)
    n = p.shape[-1] - window + 1
    if n <= 0:
        return p.new_zeros(p.shape[:-1] + (0,), dtype=torch.float32)
    total = p[..., :n]
    for i in range(1, window):
        total = total + p[..., i : i + n]
    return (total / window).to(torch.float32)


def count_accepts(probs, cutoffs, ignore_slices_after_accept: int) -> torch.Tensor:
    """Per-cutoff accept counts with a refractory cooldown (roc.py:30-62).

    probs [..., T] -> int64 counts [..., len(cutoffs)], the cutoffs one axis
    (at most 512 of them on a CUDA tensor).  Per probability the cooldown
    decrements (min 0); an accept fires when the cooldown is 0 and prob >
    cutoff, and resets the cooldown to ``ignore_slices_after_accept``.  A
    CUDA tensor takes the kernel (``accepts_kernel.count_accepts``: one
    launch, no host sync); anything else ``count_accepts_plain``.
    """
    cut = np.asarray(cutoffs, np.float32)
    if cut.ndim != 1:
        raise ValueError(f"cutoffs must be one axis, got shape {cut.shape}")
    if isinstance(probs, torch.Tensor) and probs.device.type == "cuda":
        return accepts_kernel.count_accepts(probs, cut, ignore_slices_after_accept)
    return count_accepts_plain(probs, cut, ignore_slices_after_accept)


def count_accepts_plain(probs, cutoffs, ignore_slices_after_accept: int) -> torch.Tensor:
    """``count_accepts`` as a loop over time on any device, the plain version
    that the kernel is held against."""
    p = _as_tensor(probs, torch.float32)
    cut = torch.as_tensor(np.asarray(cutoffs, np.float32), device=p.device)
    reset = int(ignore_slices_after_accept)
    cooldown = torch.full(p.shape[:-1] + cut.shape, reset, dtype=torch.int32, device=p.device)
    counts = torch.zeros(cooldown.shape, dtype=torch.int64, device=p.device)
    for t in range(p.shape[-1]):
        cooldown = torch.clamp(cooldown - 1, min=0)
        fire = (cooldown == 0) & (p[..., t, None] > cut)
        cooldown = torch.where(fire, reset, cooldown)
        counts += fire
    return counts


def count_crossings(probs, threshold: float = 0.5, refractory: int = 0) -> int:
    """0.5-crossing false accepts with a refractory index window (roc.py:65-100).

    Fires at index i when previous <= threshold < p and i - last_accept >
    refractory, with previous = 0 and last_accept = 0 at the start.
    """
    p = _as_tensor(probs, torch.float32).reshape(-1).cpu()
    thr = torch.tensor(threshold, dtype=torch.float32)
    previous = torch.nn.functional.pad(p[:-1], (1, 0))
    candidates = torch.nonzero((previous <= thr) & (p > thr)).reshape(-1).tolist()
    fires, last_accept = 0, 0
    for i in candidates:
        if i - last_accept > refractory:
            fires += 1
            last_accept = i
    return fires


def compute_false_accepts_per_hour(
    streaming_probabilities_list: List,
    cutoffs: np.ndarray = DEFAULT_CUTOFFS,
    ignore_slices_after_accept: int = 75,
    stride: int = 1,
    step_s: float = 0.02,
) -> np.ndarray:
    """False accepts per hour at each cutoff over a list of ambient tracks."""
    total = np.zeros(len(cutoffs))
    hours = 0.0
    for track in streaming_probabilities_list:
        track = _as_tensor(track, torch.float32).reshape(-1)
        if track.numel() == 0:
            continue
        hours += track.numel() * stride * step_s / 3600.0
        total += count_accepts(track, cutoffs, ignore_slices_after_accept).cpu().numpy()
    if hours <= 0:
        return np.zeros(len(cutoffs))
    return total / hours


def generate_roc_curve(
    false_accepts_per_hour: np.ndarray,
    false_rejections: Sequence[float],
    cutoffs: np.ndarray = DEFAULT_CUTOFFS,
    max_faph: float = 2.0,
):
    """ROC coordinates: faph (x) vs false-rejection rate (y), anchored at
    max_faph and ended at (0, 1) if no cutoff reaches 0 faph.

    Keeps the JAX package's two fixes of the reference (roc.py:140-143): the
    anchor interpolates between both endpoints, and uses max_faph.
    """
    faph = np.asarray(false_accepts_per_hour, dtype=np.float64)
    fnr = np.asarray(false_rejections, dtype=np.float64)
    cutoffs = np.asarray(cutoffs, dtype=np.float64)

    if faph[0] > max_faph:
        i = 1
        while faph[i] > max_faph:
            i += 1
        x0, y0 = faph[i - 1], fnr[i - 1]
        x1, y1 = faph[i], fnr[i]
        fnr_at_max = (y0 * (x1 - max_faph) + y1 * (max_faph - x0)) / (x1 - x0)
        cutoff_at_max = (cutoffs[i] + cutoffs[i - 1]) / 2.0
        first = i
    else:
        first = 0
        fnr_at_max = fnr[0]
        cutoff_at_max = cutoffs[0]

    xs, ys, cs = [max_faph], [fnr_at_max], [cutoff_at_max]
    for i in range(first, len(fnr)):
        if faph[i] != xs[-1]:
            xs.append(faph[i])
            ys.append(fnr[i])
            cs.append(cutoffs[i])
    if xs[-1] > 0:
        xs.append(0.0)
        ys.append(1.0)
        cs.append(0.0)
    return np.flip(xs), np.flip(ys), np.flip(cs)


def roc_auc(x_coordinates: np.ndarray, y_coordinates: np.ndarray) -> float:
    """Area under the faph-vs-FRR curve by the trapezoid rule."""
    return float(np.trapezoid(y_coordinates, x_coordinates))
