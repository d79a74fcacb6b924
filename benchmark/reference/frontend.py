"""The plain reference of the micro-frontend (TFLM micro_speech features),
written for the benchmark from the published constants and imports nothing
of the program.

Per hop of 10 or 20 ms over 16 kHz int16 PCM: a 480-sample Hann window, the
512-point DFT (a matmul against cos/sin tables), the power of 257 bins, the
40 mel channels' triangle weights, sqrt / 8; the noise estimate
``est = (1 - s) est + s x`` from zero (s = 0.025 on even channels, 0.06 on
odd), noise subtraction, PCAN gain (strength 0.95, offset 10), the Q6 floor,
the log scale and the clip to uint16, times 0.0390625.  It computes in the
``dtype`` it is given (float64 by default).
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE = 16000
WINDOW = 480
FFT = 512
BINS = FFT // 2 + 1
CHANNELS = 40
LOWER_HZ, UPPER_HZ = 125.0, 7500.0
SMOOTHING = (0.025, 0.06)  # even, odd channels
MIN_SIGNAL_REMAINING = 0.05
PCAN_STRENGTH, PCAN_OFFSET = 0.95, 10.0
PCAN_OUTPUT_BITS, CORRECTION_BITS, LOG_SCALE_SHIFT = 6, 3, 6
FEATURE_SCALE = 0.0390625


def hop_samples(step_ms: int) -> int:
    return SAMPLE_RATE * step_ms // 1000


def num_frames(samples: int, step_ms: int) -> int:
    return 1 + (samples - WINDOW) // hop_samples(step_ms) if samples >= WINDOW else 0


def _mel(freq):
    return 1127.0 * np.log1p(np.asarray(freq, np.float64) / 700.0)


def mel_weights() -> np.ndarray:
    """[257, 40] triangles on the mel scale between 125 and 7500 Hz: channel
    c rises over (edge c-1, edge c] and falls over (edge c, edge c+1]."""
    lo, hi = _mel(LOWER_HZ), _mel(UPPER_HZ)
    spacing = (hi - lo) / (CHANNELS + 1)
    edges = lo + spacing * np.arange(CHANNELS + 2)
    out = np.zeros((BINS, CHANNELS))
    for b, m in enumerate(_mel(np.arange(BINS) * SAMPLE_RATE / FFT)):
        if m <= edges[0] or m > edges[-1]:
            continue
        k = min(max(int(np.searchsorted(edges, m, side="left")) - 1, 0), CHANNELS)
        frac = (m - edges[k]) / spacing
        if k < CHANNELS:
            out[b, k] += frac
        if k >= 1:
            out[b, k - 1] += 1.0 - frac
    return out


def _tables(device, dtype):
    n = np.arange(WINDOW)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * (n + 0.5) / WINDOW)
    angle = 2.0 * np.pi * np.outer(n, np.arange(BINS)) / FFT
    dft = np.concatenate([window[:, None] * np.cos(angle), window[:, None] * -np.sin(angle)], 1)
    smoothing = np.where(np.arange(CHANNELS) % 2 == 0, *SMOOTHING)
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in (dft, mel_weights(), smoothing)]


def features(pcm: torch.Tensor, step_ms: int = 10, dtype=torch.float64) -> torch.Tensor:
    """[B, N] int16 PCM -> [B, T, 40] features in ``dtype`` (multiples of
    0.0390625 in [0, 2560))."""
    dft, mel, smoothing = _tables(pcm.device, dtype)
    hop = hop_samples(step_ms)
    t = num_frames(pcm.shape[1], step_ms)
    frames = pcm.to(dtype).unfold(1, WINDOW, hop)[:, :t]  # [B, T, 480]
    spec = frames @ dft
    power = spec[..., :BINS] ** 2 + spec[..., BINS:] ** 2
    filterbank = torch.sqrt(torch.clamp(power @ mel, min=0.0)) / 8.0
    est = torch.zeros_like(filterbank[:, 0])
    ests = []
    for i in range(t):
        est = (1.0 - smoothing) * est + smoothing * filterbank[:, i]
        ests.append(est)
    est = torch.stack(ests, 1) if ests else filterbank
    sub = torch.maximum(filterbank - torch.minimum(est, filterbank), MIN_SIGNAL_REMAINING * filterbank)
    snr = sub / 8.0 * (1.0 + est / PCAN_OFFSET) ** (-PCAN_STRENGTH)
    pcan = torch.where(snr < 2.0, snr * snr / 4.0, snr - 1.0)
    value = torch.floor(pcan * 2**PCAN_OUTPUT_BITS) * 2**CORRECTION_BITS
    logged = torch.where(value > 1.0, torch.log(value.clamp(min=1.0)) * 2**LOG_SCALE_SHIFT, 0.0)
    return torch.clamp(torch.round(logged), 0, 65535) * FEATURE_SCALE


def levels(feats: torch.Tensor) -> torch.Tensor:
    """Features as whole multiples of ``FEATURE_SCALE``, float64."""
    return torch.round(feats.double() / FEATURE_SCALE)


def merge(own: torch.Tensor, given: torch.Tensor) -> torch.Tensor:
    """``own`` where its level equals that of ``given``, ``given`` elsewhere:
    a model stage's input that differs from the reference frontend's only
    at the cells a comparison of levels counts."""
    given = given.to(own.device, own.dtype)
    return torch.where(levels(own) == levels(given), own, given)
