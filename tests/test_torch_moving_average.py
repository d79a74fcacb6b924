"""The port's accept counting over saturated probabilities: each window's
mean is the mean of its own probabilities, so cutoff 0 fires on a window of
tiny ones however large the stream's sum before it.  A seeded Inception
with drawn serving statistics streams such probabilities (logits of 1e4 to
1e6: exact 0s and 1s, and values of 1e-30 between them)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from microwakeword_tpu_torch.evaluate import roc


def _saturated_track() -> np.ndarray:
    """200 steps of 0.7, so the running sum is 140 and not an integer, then
    100 steps of tiny probabilities, then exact 0s and 1s."""
    rng = np.random.default_rng(0)
    tiny = (10.0 ** -rng.uniform(20, 40, 100)).astype(np.float32)
    ones = (rng.random(200) < 0.5).astype(np.float32)
    return np.concatenate([np.full(200, 0.7, np.float32), tiny, ones])


def _window_mean(track: np.ndarray, window: int) -> np.ndarray:
    return sliding_window_view(track.astype(np.float64), window, axis=-1).mean(-1).astype(
        np.float32)


@pytest.mark.parametrize("window", [1, 5, 10])
def test_window_mean_of_its_own_probabilities(window):
    track = _saturated_track()
    got = roc.moving_average(torch.from_numpy(track), window).numpy()
    want = _window_mean(track, window)
    np.testing.assert_array_equal(got, want)
    assert (got[200:300 - window + 1] > 0).all()


def test_cutoff_zero_counts_tiny_windows():
    """Batched tracks: the tiny stretch's accepts at cutoff 0 are counted
    (three in its 96 windows with a cooldown of 25), and every cutoff's count equals
    the count over the windows' own means."""
    tracks = np.stack([_saturated_track(), _saturated_track()[::-1].copy()])
    ma = roc.moving_average(torch.from_numpy(tracks), 5)
    got = roc.count_accepts(ma, roc.DEFAULT_CUTOFFS, 25).numpy()
    want = roc.count_accepts(torch.from_numpy(_window_mean(tracks, 5)), roc.DEFAULT_CUTOFFS,
                             25).numpy()
    np.testing.assert_array_equal(got, want)
    tiny_only = roc.count_accepts(ma[0, 200:296], roc.DEFAULT_CUTOFFS, 25).numpy()
    assert tiny_only[0] == 3 and tiny_only[1:].sum() == 0
