"""Constants of the micro_speech feature frontend (own copy for the port).

The same values and formulas as ``microwakeword_tpu/frontend/reference.py``
(constants, ``hann_window``, ``freq_to_mel``, ``mel_filterbank_matrix``,
``_SMOOTHING``); the port keeps its own copy so that it imports nothing of the
JAX package.  NumPy only.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
WINDOW_SIZE_MS = 30
WINDOW_SAMPLES = SAMPLE_RATE * WINDOW_SIZE_MS // 1000  # 480
FFT_SIZE = 512  # next power of two >= 480
N_FFT_BINS = FFT_SIZE // 2 + 1  # 257
NUM_CHANNELS = 40
LOWER_BAND_LIMIT = 125.0
UPPER_BAND_LIMIT = 7500.0

# Noise suppression (TFLM noise_reduction defaults).
EVEN_SMOOTHING = 0.025
ODD_SMOOTHING = 0.06
MIN_SIGNAL_REMAINING = 0.05

# PCAN auto gain (offset 80 in gain-LUT units = 10 in scaled-filterbank units).
PCAN_STRENGTH = 0.95
PCAN_OFFSET = 10.0
PCAN_OUTPUT_BITS = 6  # PCAN output is floored to Q6 before the log stage

# Log scale: uint16 = ln(value << CORRECTION_BITS) * 2**LOG_SCALE_SHIFT.
LOG_SCALE_SHIFT = 6
CORRECTION_BITS = 3

FEATURE_SCALE = 0.0390625  # uint16 -> float features in [0, ~26]


def hop_samples(step_ms: int) -> int:
    """Hop in samples for a 10 or 20 ms step."""
    if step_ms not in (10, 20):
        raise ValueError("step_ms must be 10 or 20")
    return SAMPLE_RATE * step_ms // 1000


def num_frames(n_samples: int, hop: int) -> int:
    """Frames of a clip: 1 + (N - 480) // hop, and 0 below one window."""
    return 1 + (n_samples - WINDOW_SAMPLES) // hop if n_samples >= WINDOW_SAMPLES else 0


def hann_window(n: int = WINDOW_SAMPLES) -> np.ndarray:
    """TFLM window coefficients: 0.5 - 0.5*cos(2*pi*(i+0.5)/n)."""
    i = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * (i + 0.5) / n)


def freq_to_mel(freq):
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


def mel_filterbank_matrix() -> np.ndarray:
    """The [N_FFT_BINS, NUM_CHANNELS] mel weight matrix, TFLM style.

    ``NUM_CHANNELS + 1`` band edges equally spaced on the mel scale above the
    lower band limit; channel ``c`` is a triangle rising over
    (edge[c-1], edge[c]] and falling over (edge[c], edge[c+1]].  Bins at or
    below the lower limit and above the upper limit contribute nothing.
    """
    mel_low = freq_to_mel(LOWER_BAND_LIMIT)
    mel_hi = freq_to_mel(UPPER_BAND_LIMIT)
    spacing = (mel_hi - mel_low) / float(NUM_CHANNELS + 1)
    edges = mel_low + spacing * np.arange(NUM_CHANNELS + 2)

    bin_freqs = np.arange(N_FFT_BINS) * (SAMPLE_RATE / float(FFT_SIZE))
    bin_mels = freq_to_mel(bin_freqs)

    weights = np.zeros((N_FFT_BINS, NUM_CHANNELS), dtype=np.float64)
    for b in range(N_FFT_BINS):
        m = bin_mels[b]
        if m <= edges[0] or m > edges[NUM_CHANNELS + 1]:
            continue
        k = int(np.searchsorted(edges, m, side="left")) - 1
        k = min(max(k, 0), NUM_CHANNELS)
        frac = (m - edges[k]) / spacing
        if k < NUM_CHANNELS:
            weights[b, k] += frac
        if k - 1 >= 0:
            weights[b, k - 1] += 1.0 - frac
    return weights


# Per-channel noise-estimate smoothing: even channels 0.025, odd 0.06.
SMOOTHING = np.where(np.arange(NUM_CHANNELS) % 2 == 0, EVEN_SMOOTHING, ODD_SMOOTHING)
