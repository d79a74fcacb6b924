"""Augmentation DSP primitives (NumPy/SciPy): the port's own copy of
``microwakeword_tpu/audio/dsp.py``, the same code, so that the same generator
state gives the same arrays.

From-scratch equivalents of the audiomentations transforms the reference
composes (augmentation.py:116-162): parametric EQ, tanh distortion, pitch
shift, band-stop filter, colored noise, background mixing at SNR, gain and
gain transitions, impulse-response reverberation, and clip normalization.
All functions take/return float32 mono 16 kHz audio in [-1, 1].
"""

from __future__ import annotations

import numpy as np
from scipy import signal

SAMPLE_RATE = 16000


def _rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x)) + 1e-12))


def seven_band_parametric_eq(
    audio: np.ndarray, rng: np.random.Generator,
    min_gain_db: float = -6.0, max_gain_db: float = 6.0,
) -> np.ndarray:
    """Seven peaking biquads at log-spaced centers with random gains."""
    out = audio.astype(np.float64)
    centers = np.geomspace(60.0, 7000.0, 7)
    for fc in centers:
        gain_db = rng.uniform(min_gain_db, max_gain_db)
        # RBJ peaking EQ biquad
        a = 10 ** (gain_db / 40.0)
        w0 = 2 * np.pi * fc / SAMPLE_RATE
        q = 1.0
        alpha = np.sin(w0) / (2 * q)
        b = [1 + alpha * a, -2 * np.cos(w0), 1 - alpha * a]
        ad = [1 + alpha / a, -2 * np.cos(w0), 1 - alpha / a]
        out = signal.lfilter(np.asarray(b) / ad[0], np.asarray(ad) / ad[0], out)
    return out.astype(np.float32)


def tanh_distortion(
    audio: np.ndarray, rng: np.random.Generator,
    min_distortion: float = 0.0001, max_distortion: float = 0.10,
) -> np.ndarray:
    """Soft-clipping distortion; amount controls the drive."""
    amount = rng.uniform(min_distortion, max_distortion)
    # map amount (0..1) to a drive factor; preserve loudness approximately
    drive = 1.0 + 14.0 * amount
    distorted = np.tanh(audio * drive)
    in_rms, out_rms = _rms(audio), _rms(distorted)
    if out_rms > 0:
        distorted = distorted * (in_rms / out_rms)
    return distorted.astype(np.float32)


def pitch_shift(
    audio: np.ndarray, rng: np.random.Generator,
    min_semitones: float = -3.0, max_semitones: float = 3.0,
) -> np.ndarray:
    """Phase-vocoder time stretch + resample => pitch shift, same duration."""
    semitones = rng.uniform(min_semitones, max_semitones)
    if abs(semitones) < 1e-3:
        return audio
    factor = 2.0 ** (semitones / 12.0)  # frequency scaling
    n_fft, hop = 1024, 256
    f, t, stft = signal.stft(
        audio, nperseg=n_fft, noverlap=n_fft - hop, window="hann"
    )
    # time-stretch by 1/factor via frame interpolation with phase accumulation
    n_frames = stft.shape[1]
    times = np.arange(0, n_frames - 1, 1.0 / factor)
    mag = np.abs(stft)
    phase = np.angle(stft)
    d_phase = np.diff(phase, axis=1)
    out = np.zeros((stft.shape[0], len(times)), dtype=complex)
    acc = phase[:, 0].copy()
    for i, ti in enumerate(times):
        j = int(ti)
        frac = ti - j
        m = mag[:, j] * (1 - frac) + mag[:, min(j + 1, n_frames - 1)] * frac
        out[:, i] = m * np.exp(1j * acc)
        acc += d_phase[:, min(j, n_frames - 2)]
    _, stretched = signal.istft(out, nperseg=n_fft, noverlap=n_fft - hop, window="hann")
    # resample stretched audio by factor to shift pitch, restoring duration
    shifted = signal.resample(stretched, int(round(len(stretched) / factor)))
    if len(shifted) >= len(audio):
        shifted = shifted[: len(audio)]
    else:
        shifted = np.pad(shifted, (0, len(audio) - len(shifted)))
    return shifted.astype(np.float32)


def band_stop_filter(
    audio: np.ndarray, rng: np.random.Generator,
    min_center_freq: float = 200.0, max_center_freq: float = 4000.0,
    min_bandwidth_fraction: float = 0.5, max_bandwidth_fraction: float = 1.99,
) -> np.ndarray:
    """2nd-order Butterworth band-stop with random center/bandwidth."""
    fc = np.exp(rng.uniform(np.log(min_center_freq), np.log(max_center_freq)))
    bw = fc * rng.uniform(min_bandwidth_fraction, max_bandwidth_fraction)
    low = max(10.0, fc - bw / 2)
    high = min(SAMPLE_RATE / 2 - 100, fc + bw / 2)
    if low >= high:
        return audio
    sos = signal.butter(2, [low, high], btype="bandstop", fs=SAMPLE_RATE, output="sos")
    return signal.sosfilt(sos, audio.astype(np.float64)).astype(np.float32)


def colored_noise(
    n: int, rng: np.random.Generator, f_decay_db_per_octave: float
) -> np.ndarray:
    """Noise with power decaying f^(-decay/3.01) (white=0, pink=3, brown=6)."""
    white = rng.normal(0, 1, n)
    spec = np.fft.rfft(white)
    freqs = np.fft.rfftfreq(n, 1 / SAMPLE_RATE)
    freqs[0] = freqs[1] if n > 1 else 1.0
    # amplitude slope: decay dB/octave => multiply by f^(-decay/6.02)
    spec = spec * freqs ** (-f_decay_db_per_octave / 6.02)
    out = np.fft.irfft(spec, n)
    return (out / (np.abs(out).max() + 1e-9)).astype(np.float32)


def add_colored_noise(
    audio: np.ndarray, rng: np.random.Generator,
    min_snr_db: float = 10.0, max_snr_db: float = 30.0,
    min_f_decay: float = -6.0, max_f_decay: float = 6.0,
) -> np.ndarray:
    snr_db = rng.uniform(min_snr_db, max_snr_db)
    decay = rng.uniform(min_f_decay, max_f_decay)
    noise = colored_noise(len(audio), rng, decay)
    clean_rms = _rms(audio)
    noise_rms = _rms(noise)
    target_noise_rms = clean_rms / (10 ** (snr_db / 20.0))
    if noise_rms > 0:
        noise = noise * (target_noise_rms / noise_rms)
    return (audio + noise).astype(np.float32)


def add_background_noise(
    audio: np.ndarray, background: np.ndarray, rng: np.random.Generator,
    min_snr_db: float = -10.0, max_snr_db: float = 10.0,
) -> np.ndarray:
    """Mixes a random window of ``background`` at a random SNR."""
    if len(background) == 0:
        return audio
    if len(background) < len(audio):
        reps = int(np.ceil(len(audio) / len(background)))
        background = np.tile(background, reps)
    start = rng.integers(0, len(background) - len(audio) + 1)
    bg = background[start : start + len(audio)].astype(np.float32)
    snr_db = rng.uniform(min_snr_db, max_snr_db)
    clean_rms, bg_rms = _rms(audio), _rms(bg)
    if bg_rms <= 1e-9:
        return audio
    bg = bg * (clean_rms / (10 ** (snr_db / 20.0)) / bg_rms)
    return (audio + bg).astype(np.float32)


def gain(audio: np.ndarray, rng: np.random.Generator,
         min_gain_db: float = -45.0, max_gain_db: float = 0.0) -> np.ndarray:
    g = 10 ** (rng.uniform(min_gain_db, max_gain_db) / 20.0)
    return (audio * g).astype(np.float32)


def gain_transition(
    audio: np.ndarray, rng: np.random.Generator,
    min_gain_db: float = -10.0, max_gain_db: float = 10.0,
) -> np.ndarray:
    """Linear-in-dB gain ramp over a random span of the clip."""
    n = len(audio)
    if n < 2:
        return audio
    g0 = rng.uniform(min_gain_db, max_gain_db)
    g1 = rng.uniform(min_gain_db, max_gain_db)
    t0 = rng.integers(0, n - 1)
    t1 = rng.integers(t0 + 1, n + 1)
    ramp_db = np.full(n, g0)
    ramp_db[t0:t1] = np.linspace(g0, g1, t1 - t0)
    ramp_db[t1:] = g1
    return (audio * 10 ** (ramp_db / 20.0)).astype(np.float32)


def apply_impulse_response(audio: np.ndarray, ir: np.ndarray) -> np.ndarray:
    """Reverberates by FFT convolution, trimmed to the input length."""
    if len(ir) == 0:
        return audio
    wet = signal.fftconvolve(audio, ir / (np.abs(ir).max() + 1e-9))[: len(audio)]
    in_rms, wet_rms = _rms(audio), _rms(wet)
    if wet_rms > 0:
        wet = wet * (in_rms / wet_rms)
    return wet.astype(np.float32)


def normalize_if_clipped(audio: np.ndarray) -> np.ndarray:
    """audiomentations Normalize(apply_to='only_too_loud_sounds')."""
    peak = np.abs(audio).max() if len(audio) else 0.0
    if peak > 1.0:
        return (audio / peak).astype(np.float32)
    return audio
