"""The float golden frontend on tensors (port of ``frontend/reference.py``).

The JAX package keeps this NumPy frontend as its host-side reference of the
TFLM ``audio_microfrontend`` op: a 30 ms Hann window every ``step_ms``, the
512-point real FFT, the 40-channel mel filterbank, sqrt / 8, the per-channel
noise estimate, PCAN, the Q6 floor and the log scale, all in float64 with the
stage structure and constants of the C op (``frontend/constants.py``).

Here the same arithmetic runs in PyTorch in float64 on ``device`` (None: the
card, by ``resolve_device``).  The per-channel noise estimate is the carried
state: the frames' estimates follow one another (one small update per frame),
and every other stage runs on all frames at once with the same elementwise
operations, so chunked calls equal one call over the whole clip.  Against the
NumPy reference the FFT and the mel product may sum in another order, and
``pow`` and ``log`` may differ by an ulp: the port is held to it under the Q6
gate (``frontend/gate.py``), with equality expected.

Features are uint16 tensors on the device, [n_frames, 40];
``generate_features_for_clip`` returns float32 features in [0, ~26].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.frontend import constants as C
from microwakeword_tpu_torch.frontend.constants import (  # noqa: F401
    FEATURE_SCALE,
    NUM_CHANNELS,
    SAMPLE_RATE,
    WINDOW_SAMPLES,
)
from microwakeword_tpu_torch.frontend.plain import float_pcm_to_int16, frame_audio


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """Hann window [480], mel matrix [257, 40] and smoothing [40], float64 on
    ``device``."""
    return tuple(torch.from_numpy(np.asarray(a, np.float64)).to(device)
                 for a in (C.hann_window(), C.mel_filterbank_matrix(), C.SMOOTHING))


def scaled_filterbank(frames: torch.Tensor) -> torch.Tensor:
    """[n, 480] float64 frames -> [n, 40] amplitudes in the C op's units,
    sqrt(sum(w_mel |X|^2)) / 8."""
    window, mel, _ = _tables(frames.device)
    spec = torch.fft.rfft(frames * window, n=C.FFT_SIZE, dim=-1)
    energy = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(torch.clamp(energy @ mel, min=0.0)) / 8.0


def frontend_frames(frames, noise_estimate, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The frontend over [n, 480] frames (float samples) from the carried
    [40] noise estimate: ([n, 40] uint16 features, the final estimate), on
    ``device``."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, dtype=torch.float64, device=dev)
    est = torch.as_tensor(noise_estimate, dtype=torch.float64, device=dev).clone()
    if frames.shape[0] == 0:
        return torch.zeros((0, NUM_CHANNELS), dtype=torch.uint16, device=dev), est
    sf = scaled_filterbank(frames)
    smoothing = _tables(dev)[2]
    # noise reduction's estimate, frame by frame: (1 - s) est + s x
    pulled = smoothing * sf
    keep = 1.0 - smoothing
    ests = []
    for t in range(sf.shape[0]):
        est = keep * est + pulled[t]
        ests.append(est)
    e = torch.stack(ests)
    sub = torch.maximum(sf - torch.minimum(e, sf), C.MIN_SIGNAL_REMAINING * sf)
    # PCAN on the noise estimate: snr = (sub / 8) (1 + est / 10)^-0.95, then
    # the shrink floored to Q6.  The offset is a 0-dim tensor on the device:
    # on CUDA a Python scalar divisor becomes a multiply by its reciprocal.
    offset = e.new_tensor(C.PCAN_OFFSET)
    snr = (sub / 8.0) * torch.pow(1.0 + e / offset, -C.PCAN_STRENGTH)
    pcan = torch.where(snr < 2.0, snr * snr / 4.0, snr - 1.0)
    value = torch.floor(pcan * (1 << C.PCAN_OUTPUT_BITS)) * (1 << C.CORRECTION_BITS)
    logged = torch.where(value > 1.0,
                         torch.log(torch.clamp(value, min=1.0)) * (1 << C.LOG_SCALE_SHIFT), 0.0)
    return torch.clamp(torch.round(logged), 0, 65535).to(torch.uint16), est


class MicroFrontend:
    """The stateful float frontend, a 480-sample window at a time or a whole
    clip; the state is the per-channel noise estimate (the C op's
    noise_reduction estimate, which PCAN reads too), on ``device``."""

    def __init__(self, step_ms: int = 10, device=None):
        self.step_ms = step_ms
        self.device = resolve_device(device)
        self.noise_estimate = torch.zeros(NUM_CHANNELS, dtype=torch.float64, device=self.device)

    def reset(self) -> None:
        self.noise_estimate.zero_()

    def process_window(self, samples) -> torch.Tensor:
        """One 480-sample window -> 40 uint16 features."""
        window = torch.as_tensor(samples, device=self.device)
        feats, self.noise_estimate = frontend_frames(window[None], self.noise_estimate,
                                                     self.device)
        return feats[0]

    def process_clip(self, audio) -> torch.Tensor:
        """A clip -> [n_frames, 40] uint16 features, carrying the state."""
        frames = frame_audio(torch.as_tensor(audio, device=self.device), self.step_ms)
        feats, self.noise_estimate = frontend_frames(frames, self.noise_estimate, self.device)
        return feats


def pcm_to_int16(audio) -> np.ndarray:
    """int16 PCM as given; float PCM in [-1, 1] by the reference's rule,
    ``clip(x * 32768)`` truncated toward zero by the int16 cast."""
    audio = audio.cpu().numpy() if torch.is_tensor(audio) else np.asarray(audio)
    return float_pcm_to_int16(audio) if audio.dtype in (np.float32, np.float64) else audio


def generate_features_for_clip(audio_samples, step_ms: int = 10, device=None) -> torch.Tensor:
    """int16 (or float in [-1, 1]) PCM -> [n_frames, 40] float32 features in
    [0, ~26] on ``device`` (the reference's ``generate_features_for_clip``)."""
    fe = MicroFrontend(step_ms=step_ms, device=device)
    return fe.process_clip(pcm_to_int16(audio_samples)).to(torch.float32) * FEATURE_SCALE
