"""Plain PyTorch micro-frontend: the port of ``microwakeword_tpu/frontend/xla.py``.

This is the plain version of the CUDA kernel in ``frontend/kernel.py``: the
CPU tests use it, ``chip_smoke.py`` holds the kernel against it on the card,
and the kernel's wrapper takes it only for a tensor that lies on the CPU.

The arithmetic follows ``xla.py`` step by step so that, on the CPU, it agrees
with the JAX package cell for cell (see ``frontend/gate.py`` for the exact
tolerance and why it is stated on the Q6 level):

- framing: ``unfold`` over the sample axis, hop 160 (10 ms) or 320 (20 ms);
- window + 512-point real DFT as two [480, 257] matmuls against Hann-folded
  cos/sin matrices, energy re^2 + im^2, the [257, 40] mel matmul, sqrt / 8;
- the noise-estimate EMA ``est_t = (1-s) est_{t-1} + s x_t`` as a
  lower-triangular [T, T] matmul per channel parity (``_ema_block``), chunked
  with a carried estimate above ``_EMA_CHUNK`` frames, as in ``xla.py``;
- noise subtraction, PCAN, Q6 floor, log scale, round, clip (``_agc_output``).

Tensors are time-major: audio [..., N] -> features [..., T, 40] float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.frontend import constants as C

NUM_CHANNELS = C.NUM_CHANNELS
WINDOW_SAMPLES = C.WINDOW_SAMPLES
FEATURE_SCALE = C.FEATURE_SCALE

# Max frame count handled by one [T, T] EMA matmul; longer clips run in
# chunks of this size with the estimate carried between them (xla.py:85).
_EMA_CHUNK = 1024


@functools.lru_cache(maxsize=None)
def _dft_mel_constants():
    """Window-folded DFT cos/sin [480, 257], mel [257, 40], smoothing [40];
    computed in float64 and stored as float32 NumPy (xla.py:38-53)."""
    w = C.hann_window()
    n = np.arange(C.FFT_SIZE)
    k = np.arange(C.N_FFT_BINS)
    ang = 2.0 * np.pi * np.outer(n[: C.WINDOW_SAMPLES], k) / C.FFT_SIZE
    wc = (w[:, None] * np.cos(ang)).astype(np.float32)
    ws = (w[:, None] * -np.sin(ang)).astype(np.float32)
    mel = C.mel_filterbank_matrix().astype(np.float32)
    smoothing = C.SMOOTHING.astype(np.float32)
    return wc, ws, mel, smoothing


@functools.lru_cache(maxsize=None)
def _device_constants(device: torch.device):
    """The constants of ``_dft_mel_constants`` as tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in _dft_mel_constants())


@functools.lru_cache(maxsize=16)
def _ema_matrices(t: int, device: torch.device):
    """EMA kernels at length T (xla.py:56-76): float64 math, float32 tensors
    on ``device``.

    low[p, t, i] = s_p (1-s_p)^(t-i) for i <= t, else 0 (p = channel parity);
    decay[t, c] = (1-s_c)^(t+1) carries the initial estimate.
    """
    sm = np.array([C.EVEN_SMOOTHING, C.ODD_SMOOTHING], np.float64)
    i = np.arange(t)
    diff = i[:, None] - i[None, :]
    low = np.where(
        diff >= 0,
        sm[:, None, None] * (1.0 - sm[:, None, None]) ** np.maximum(diff, 0),
        0.0,
    )
    decay = (1.0 - C.SMOOTHING.astype(np.float64))[None, :] ** (i[:, None] + 1)
    return (torch.from_numpy(low.astype(np.float32)).to(device),
            torch.from_numpy(decay.astype(np.float32)).to(device))


def _ema_block(sf: torch.Tensor, noise_estimate: torch.Tensor, t: int) -> torch.Tensor:
    """Noise-estimate EMA over one [..., t, 40] block by the triangular matmul."""
    low, decay = _ema_matrices(t, sf.device)
    bsf = sf.reshape(sf.shape[:-1] + (NUM_CHANNELS // 2, 2))
    est = torch.einsum("pti,...ikp->...tkp", low, bsf).reshape(sf.shape)
    return est + decay * noise_estimate[..., None, :]


def frame_audio(audio: torch.Tensor, step_ms: int = 10) -> torch.Tensor:
    """[..., N] samples -> [..., T, 480] overlapping frames, hop 16*step_ms."""
    hop = C.hop_samples(step_ms)
    if C.num_frames(audio.shape[-1], hop) == 0:
        return audio.new_zeros(audio.shape[:-1] + (0, WINDOW_SAMPLES))
    return audio.unfold(-1, WINDOW_SAMPLES, hop)


def scaled_filterbank(frames: torch.Tensor) -> torch.Tensor:
    """[..., T, 480] float32 frames -> [..., T, 40] scaled-filterbank amplitudes."""
    wc, ws, mel, _ = _device_constants(frames.device)
    re = frames @ wc
    im = frames @ ws
    energy = re * re + im * im
    return torch.sqrt(torch.clamp(energy @ mel, min=0.0)) / 8.0


def _agc_output(s: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """Noise subtraction + PCAN + log scale given the per-hop noise estimates
    (xla.py:229-242); returns uint16-valued float32 features."""
    sub = torch.maximum(s - torch.minimum(est, s), C.MIN_SIGNAL_REMAINING * s)
    # A 0-dim tensor on est's device, not a Python scalar: on CUDA, PyTorch
    # turns division by a CPU scalar into multiplication by its reciprocal,
    # which rounds differently from the true division the JAX package does.
    offset = est.new_tensor(C.PCAN_OFFSET)
    snr = (sub / 8.0) * torch.pow(1.0 + est / offset, -C.PCAN_STRENGTH)
    pcan = torch.where(snr < 2.0, snr * snr / 4.0, snr - 1.0)
    pcan_q6 = torch.floor(pcan * (1 << C.PCAN_OUTPUT_BITS))
    value = pcan_q6 * (1 << C.CORRECTION_BITS)
    logged = torch.where(
        value > 1.0,
        torch.log(torch.clamp(value, min=1.0)) * (1 << C.LOG_SCALE_SHIFT),
        0.0,
    )
    return torch.clamp(torch.round(logged), 0, 65535)


def frontend_streaming(
    sf: torch.Tensor, noise_estimate: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """AGC over precomputed scaled-filterbank amplitudes with explicit state.

    sf: [..., T, 40] (time on axis -2); noise_estimate: [..., 40].
    Returns (features [..., T, 40] float32 in [0, 26], final estimate).
    The JAX function's associative-scan fallback for other time axes
    (xla.py:207-226) is not ported: the port keeps time on axis -2.
    """
    t = sf.shape[-2]
    if t == 0:
        return sf * FEATURE_SCALE, noise_estimate
    if t <= _EMA_CHUNK:
        est = _ema_block(sf, noise_estimate, t)
    else:
        # Chunked with the carried estimate, padded to whole chunks as
        # xla.py:183-202 does, so the chunk boundaries are the same.
        chunk = _EMA_CHUNK
        nc = -(-t // chunk)
        pad = nc * chunk - t
        sfp = torch.nn.functional.pad(sf, (0, 0, 0, pad))
        carry = noise_estimate
        parts = []
        for j in range(nc):
            e = _ema_block(sfp[..., j * chunk : (j + 1) * chunk, :], carry, chunk)
            carry = e[..., -1, :]
            parts.append(e)
        est = torch.cat(parts, dim=-2)[..., :t, :]
    final = est[..., -1, :]
    return _agc_output(sf, est) * FEATURE_SCALE, final


def float_pcm_to_int16(audio: np.ndarray) -> np.ndarray:
    """Float PCM in [-1, 1] -> int16 by the JAX package's per-clip rule
    (``frontend/reference.py:220``): ``clip(x * 32768)`` truncated toward
    zero by the int16 cast.  ``frontend_batch`` rounds instead, as
    ``xla.py`` does; the per-clip entry points (``Model.predict_clip``,
    ``SpectrogramGeneration.frontend``) convert by this rule first."""
    return np.clip(audio * 32768, -32768, 32767).astype(np.int16)


def frontend_batch(audio: torch.Tensor, step_ms: int = 10) -> torch.Tensor:
    """[B, N] int16/float samples -> [B, T, 40] float32 features in [0, 26].

    Floats are read in [-1, 1] with the reference's clip(x * 32768)
    convention and round-half-even (xla.py:252-254).
    """
    if audio.dtype.is_floating_point:
        audio = torch.round(torch.clamp(audio.to(torch.float32) * 32768.0, -32768.0, 32767.0))
    frames = frame_audio(audio.to(torch.float32), step_ms)
    sf = scaled_filterbank(frames)
    est0 = sf.new_zeros(sf.shape[:-2] + (NUM_CHANNELS,))
    feats, _ = frontend_streaming(sf, est0)
    return feats


def streaming_state_init(batch_shape: tuple = (), device=None) -> torch.Tensor:
    """Initial noise-estimate state for ``frontend_streaming``/``frontend_step``."""
    return torch.zeros(batch_shape + (NUM_CHANNELS,), device=resolve_device(device))


def frontend_step(
    window: torch.Tensor, noise_estimate: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One hop: [..., 480] samples -> ([..., 40] features, new estimate)."""
    sf = scaled_filterbank(window.to(torch.float32))
    smoothing = _device_constants(sf.device)[3]
    est = (1.0 - smoothing) * noise_estimate + smoothing * sf
    return _agc_output(sf, est) * FEATURE_SCALE, est
