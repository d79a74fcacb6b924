"""The integer-exact frontend on tensors (port of ``frontend/fixedpoint.py``).

The JAX package's re-derivation of the C ``audio_microfrontend`` op's
fixed-point pipeline, bit-exact with the op that runs on the ESP32
(``tests/test_frontend.py`` holds it to the golden vectors recorded from the
op): the Hann window as int16 Q12 coefficients with a floor shift; an exact
emulation of kissfft's int16 real FFT (a 256-point complex FFT as four
radix-4 stages with Q15 twiddles, ``DIVSCALAR`` scaling and rounded complex
multiplies, then kiss_fftr's split step); Q12 mel weights summed in integers
and an exact integer square root; the noise estimate in Q14 smoothing with
floor shifts; the PCAN gain from the C op's lookup table with its quadratic
interpolation per octave; the shrink; and the log scale.

Every stage after the tables runs in int64 tensors on ``device`` (None: the
card, by ``resolve_device``).  The tables (the window, the mel weights, the
FFT's twiddles and the PCAN gain table) come from float32 and float64
arithmetic as the C op's setup code computes them; they are built once with
NumPy on the host (this module's own copy of that code) and then moved to the
device.  The noise estimate is the carried state: its update runs frame by
frame, every other stage on all frames at once, so chunked calls equal one
call over the whole clip.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.frontend import constants as C
from microwakeword_tpu_torch.frontend.plain import frame_audio
from microwakeword_tpu_torch.frontend.reference import pcm_to_int16


# ---- quantized tables, on the host ----------------------------------------
def _window_q12_f32() -> np.ndarray:
    """int16 Q12 Hann coefficients: float32 trig, rounded (window_util.c)."""
    i = np.arange(C.WINDOW_SAMPLES, dtype=np.float32)
    arg = np.float32(2.0 * np.pi) / np.float32(C.WINDOW_SAMPLES)
    w = (np.float32(0.5) - np.float32(0.5) * np.cos(arg * (i + np.float32(0.5))))
    return np.floor(w * (1 << 12) + 0.5).astype(np.int64)


def _mel_q12_f32() -> np.ndarray:
    """[257, 40] Q12 mel weights: float32 mel math, rounded (filterbank_util.c)."""

    def f2m(f):
        return np.float32(1127.0) * np.log1p(np.asarray(f, np.float32) / np.float32(700.0))

    mel_low = f2m(C.LOWER_BAND_LIMIT)
    mel_hi = f2m(C.UPPER_BAND_LIMIT)
    spacing = (mel_hi - mel_low) / np.float32(C.NUM_CHANNELS + 1)
    edges = mel_low + spacing * np.arange(C.NUM_CHANNELS + 2, dtype=np.float32)
    bins = f2m(np.arange(C.N_FFT_BINS) * (C.SAMPLE_RATE / float(C.FFT_SIZE)))
    weights = np.zeros((C.N_FFT_BINS, C.NUM_CHANNELS))
    for b in range(C.N_FFT_BINS):
        m = bins[b]
        if m <= edges[0] or m > edges[C.NUM_CHANNELS + 1]:
            continue
        k = int(np.searchsorted(edges, m, side="left")) - 1
        k = min(max(k, 0), C.NUM_CHANNELS)
        frac = float((m - edges[k]) / spacing)
        if k < C.NUM_CHANNELS:
            weights[b, k] += frac
        if k - 1 >= 0:
            weights[b, k - 1] += 1.0 - frac
    return np.floor(weights * (1 << 12) + 0.5).astype(np.int64)


SMOOTHING_BITS = 10
NR_BITS = 14  # noise-reduction Q format
EVEN_SMOOTHING_Q14 = int(0.025 * (1 << NR_BITS))
ODD_SMOOTHING_Q14 = int(0.06 * (1 << NR_BITS))
MIN_SIGNAL_Q14 = int(0.05 * (1 << NR_BITS))

GAIN_BITS = 21
PCAN_STRENGTH = 0.95
PCAN_OFFSET = 80.0
CORRECTION_BITS = 3  # bit_length(512) - 1 - kFilterbankBits // 2
PCAN_INPUT_BITS = SMOOTHING_BITS - CORRECTION_BITS  # 7
SNR_SHIFT = GAIN_BITS - CORRECTION_BITS - 12  # 6 (kPcanSnrBits = 12)
WDF_BITS = 32

LOG_SCALE_SHIFT = 6


def _pcan_lookup(x: int) -> int:
    xf = float(x) / (1 << PCAN_INPUT_BITS)
    g = (1 << GAIN_BITS) * (xf + PCAN_OFFSET) ** -PCAN_STRENGTH
    return min(int(g + 0.5), 32767)


def _pcan_lut():
    """The gain at 0, 1, 2 and each octave's (y0, a1, a2) of the quadratic
    interpolation, as the C op's gain table holds them."""
    direct = np.array([_pcan_lookup(x) for x in (0, 1, 2)], np.int64)
    y0s, a1s, a2s = (np.zeros(WDF_BITS + 1, np.int64) for _ in range(3))
    for interval in range(2, WDF_BITS + 1):
        x0 = 1 << (interval - 1)
        x1 = x0 + (x0 >> 1)
        x2 = x0 + (x0 - 1) if interval == WDF_BITS else 2 * x0
        y0, y1, y2 = _pcan_lookup(x0), _pcan_lookup(x1), _pcan_lookup(x2)
        d1, d2 = y1 - y0, y2 - y0
        a1 = 4 * d1 - d2
        y0s[interval], a1s[interval], a2s[interval] = y0, a1, d2 - a1
    return direct, y0s, a1s, a2s


_NSUB = C.FFT_SIZE // 2  # the 256-point complex FFT inside the 512-point real one


def _twiddles():
    """Q15 twiddles of the complex FFT and supertwiddles of the split step,
    ``floor(0.5 + 32767 cos)`` as kissfft rounds them."""
    i = np.arange(_NSUB)
    k = np.arange(_NSUB // 2)
    q15 = lambda a: np.floor(0.5 + 32767 * a).astype(np.int64)  # noqa: E731
    return (q15(np.cos(-2 * np.pi * i / _NSUB)), q15(np.sin(-2 * np.pi * i / _NSUB)),
            q15(np.cos(-np.pi * ((k + 1) / _NSUB + 0.5))),
            q15(np.sin(-np.pi * ((k + 1) / _NSUB + 0.5))))


@functools.lru_cache(maxsize=None)
def _host_tables() -> dict:
    direct, y0, a1, a2 = _pcan_lut()
    tw_r, tw_i, sup_r, sup_i = _twiddles()
    return dict(
        window=_window_q12_f32(), mel=_mel_q12_f32(),
        smoothing=np.where(np.arange(C.NUM_CHANNELS) % 2 == 0, EVEN_SMOOTHING_Q14,
                           ODD_SMOOTHING_Q14).astype(np.int64),
        pcan_direct=direct, pcan_y0=y0, pcan_a1=a1, pcan_a2=a2,
        tw_r=tw_r, tw_i=tw_i, sup_r=sup_r, sup_i=sup_i,
        powers=np.left_shift(1, np.arange(63, dtype=np.int64)),  # 2^0 .. 2^62
        perm=_digit_reversal(),
    )


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """``_host_tables`` as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in _host_tables().items()}


# ---- integer helpers -------------------------------------------------------
def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits of each x >= 0 (MostSignificantBit32): the powers of two <= x."""
    return (x[..., None] >= _tables(x.device)["powers"]).sum(-1)


def _isqrt(x: torch.Tensor) -> torch.Tensor:
    """Exact integer square root (floor) of values up to about 2^52: the
    float64 root, corrected by one in either direction."""
    r = torch.floor(torch.sqrt(x.to(torch.float64))).to(torch.int64)
    r = torch.where(r * r > x, r - 1, r)
    return torch.where((r + 1) * (r + 1) <= x, r + 1, r)


def wide_dynamic_function(x: torch.Tensor) -> torch.Tensor:
    """The PCAN gain of Q10 noise estimates, bit-exact: the C op's table with
    its quadratic interpolation inside each octave."""
    t = _tables(x.device)
    interval = _bit_length(x)
    frac = torch.where(interval < 11, x << torch.clamp(11 - interval, min=0),
                       x >> torch.clamp(interval - 11, min=0)) & 0x3FF
    safe = torch.clamp(interval, 2, WDF_BITS)
    result = (t["pcan_a2"][safe] * frac) >> 5
    result = (result + (t["pcan_a1"][safe] << 5)) * frac
    result = ((result + (1 << 14)) >> 15) + t["pcan_y0"][safe]
    return torch.where(x <= 2, t["pcan_direct"][torch.clamp(x, max=2)], result)


def pcan_shrink(snr: torch.Tensor) -> torch.Tensor:
    return torch.where(snr < (2 << 12), (snr * snr) >> 20, (snr >> 6) - (1 << 6))


# ---- exact int16 kissfft emulation (kiss_fft FIXED_POINT=16) ---------------
def _sround(x):
    return (x + (1 << 14)) >> 15


def _divscalar(x, k):  # kiss DIVSCALAR: sround(x * (SAMP_MAX // k))
    return _sround(x * (32767 // k))


def _c_mul(ar, ai, br, bi):  # kiss C_MUL: sround of the summed products
    return _sround(ar * br - ai * bi), _sround(ar * bi + ai * br)


def _kf_bfly4(fr, fi, fstride: int, m: int, t: dict) -> None:
    """kissfft's radix-4 butterfly, in place, on every block of the last axis
    (4 quarters of m) at once."""
    idx = torch.arange(m, device=fr.device) * fstride
    q = [(_divscalar(fr[..., j * m:(j + 1) * m], 4), _divscalar(fi[..., j * m:(j + 1) * m], 4))
         for j in range(4)]
    (a_r, a_i), (b_r, b_i), (c_r, c_i), (d_r, d_i) = q
    s0r, s0i = _c_mul(b_r, b_i, t["tw_r"][idx], t["tw_i"][idx])
    s1r, s1i = _c_mul(c_r, c_i, t["tw_r"][idx * 2], t["tw_i"][idx * 2])
    s2r, s2i = _c_mul(d_r, d_i, t["tw_r"][idx * 3], t["tw_i"][idx * 3])
    s5r, s5i = a_r - s1r, a_i - s1i
    a_r, a_i = a_r + s1r, a_i + s1i
    s3r, s3i = s0r + s2r, s0i + s2i
    s4r, s4i = s0r - s2r, s0i - s2i
    fr[..., 2 * m:3 * m], fi[..., 2 * m:3 * m] = a_r - s3r, a_i - s3i
    fr[..., 0:m], fi[..., 0:m] = a_r + s3r, a_i + s3i
    fr[..., m:2 * m], fi[..., m:2 * m] = s5r + s4i, s5i - s4r
    fr[..., 3 * m:4 * m], fi[..., 3 * m:4 * m] = s5r - s4i, s5i + s4r


def _digit_reversal() -> np.ndarray:
    """Where kissfft's recursion (``kf_work``) reads each input of its
    first, innermost butterflies: position i0 64 + i1 16 + i2 4 + k of the
    stage-by-stage layout holds input i0 + 4 i1 + 16 i2 + 64 k."""
    i0, i1, i2, k = np.indices((4, 4, 4, 4))
    return (i0 + 4 * i1 + 16 * i2 + 64 * k).reshape(-1)


def _kf_work(fr, fi, t: dict):
    """kissfft's 256-point complex FFT (``kf_work``): its recursion unrolled
    into the digit-reversed input and one radix-4 stage per level, every
    sub-FFT of a level at once; the same operations on the same values."""
    fr, fi = fr[:, t["perm"]], fi[:, t["perm"]]
    for m in (1, 4, 16, 64):  # kissfft's factors of 256 (4 x 4 x 4 x 4), innermost first
        _kf_bfly4(fr.view(fr.shape[0], -1, 4 * m), fi.view(fi.shape[0], -1, 4 * m),
                  _NSUB // (4 * m), m, t)
    return fr, fi


def kiss_fftr_int16(x, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact int16 kiss_fftr over [batch, 512] integer input on ``device``:
    ([batch, 257] real, [batch, 257] imaginary) int64 spectra with the C
    op's rounding and scaling at every stage."""
    x = torch.as_tensor(x, dtype=torch.int64, device=resolve_device(device))
    t = _tables(x.device)
    fr, fi = _kf_work(x[:, 0::2], x[:, 1::2], t)
    out_r = x.new_zeros((x.shape[0], _NSUB + 1))
    out_i = x.new_zeros((x.shape[0], _NSUB + 1))
    tdc_r, tdc_i = _divscalar(fr[:, 0], 2), _divscalar(fi[:, 0], 2)
    out_r[:, 0] = tdc_r + tdc_i
    out_r[:, _NSUB] = tdc_r - tdc_i
    k = torch.arange(1, _NSUB // 2 + 1, device=x.device)
    fpk_r, fpk_i = _divscalar(fr[:, k], 2), _divscalar(fi[:, k], 2)
    fpnk_r = _divscalar(fr[:, _NSUB - k], 2)
    fpnk_i = -_divscalar(fi[:, _NSUB - k], 2)
    f1k_r, f1k_i = fpk_r + fpnk_r, fpk_i + fpnk_i
    f2k_r, f2k_i = fpk_r - fpnk_r, fpk_i - fpnk_i
    tw_r, tw_i = _c_mul(f2k_r, f2k_i, t["sup_r"][k - 1], t["sup_i"][k - 1])
    out_r[:, 1:_NSUB // 2 + 1] = (f1k_r + tw_r) >> 1
    out_i[:, 1:_NSUB // 2 + 1] = (f1k_i + tw_i) >> 1
    # bins 256 - k, written after bins k so that bin 128 takes this value
    out_r[:, _NSUB - k] = (f1k_r - tw_r) >> 1
    out_i[:, _NSUB - k] = (tw_i - f1k_i) >> 1
    return out_r, out_i


# frames per block of the mel sum: [block, 257, 40] int64 products at a time
_MEL_BLOCK = 256


def scaled_filterbank_int(frames: torch.Tensor) -> torch.Tensor:
    """[n, 480] int64 samples -> [n, 40] integer scaled-filterbank amplitudes:
    the Q12 window, the exact int16 FFT, the Q12 mel sum, the integer root."""
    t = _tables(frames.device)
    w = (frames * t["window"]) >> 12  # int16 range, floor shift
    shift = torch.clamp(15 - _bit_length(w.abs().amax(dim=-1)), min=0)
    x = frames.new_zeros((frames.shape[0], C.FFT_SIZE))
    x[:, : C.WINDOW_SAMPLES] = w * (torch.ones_like(shift) << shift)[:, None]
    re, im = kiss_fftr_int16(x, x.device)
    energy = re * re + im * im
    # the mel sum in int64 (no integer matmul on CUDA), a block of frames at a time
    work = torch.cat([(energy[i : i + _MEL_BLOCK, :, None] * t["mel"]).sum(dim=1)
                      for i in range(0, energy.shape[0], _MEL_BLOCK)])
    return _isqrt(work) >> shift[:, None]


def frontend_frames_int(frames, noise_estimate, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The integer frontend over [n, 480] int16 frames from the carried [40]
    int64 noise estimate in Q(SMOOTHING_BITS) (the C op's noise_reduction
    estimate, shared with PCAN): ([n, 40] uint16 features, the final
    estimate), on ``device``."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, dtype=torch.int64, device=dev)
    est = torch.as_tensor(noise_estimate, dtype=torch.int64, device=dev).clone()
    if frames.shape[0] == 0:
        return torch.zeros((0, C.NUM_CHANNELS), dtype=torch.uint16, device=dev), est
    smoothing = _tables(dev)["smoothing"]
    s = scaled_filterbank_int(frames)
    s_up = s << SMOOTHING_BITS
    pulled = s_up * smoothing
    keep = (1 << NR_BITS) - smoothing
    ests = []
    for i in range(s.shape[0]):
        est = (pulled[i] + est * keep) >> NR_BITS
        ests.append(est)
    e = torch.stack(ests)
    floor_v = (s * MIN_SIGNAL_Q14) >> NR_BITS
    signal = torch.maximum(torch.clamp(s_up - e, min=0) >> SMOOTHING_BITS, floor_v)
    pcan = pcan_shrink((signal * wide_dynamic_function(e)) >> SNR_SHIFT)
    # the one float step: round(ln(pcan << 3) * 64) of an integer.  A card's
    # log may differ from the CPU's by an ulp, so this is the one place where
    # the card's features may differ from the CPU's.
    v = (pcan << CORRECTION_BITS).to(torch.float64)
    logged = torch.where(v > 1.0, torch.round(torch.log(torch.clamp(v, min=1.0))
                                              * (1 << LOG_SCALE_SHIFT)), 0.0)
    return torch.clamp(logged, 0, 65535).to(torch.uint16), est


class MicroFrontendInt:
    """The stateful integer-exact frontend, with ``reference.MicroFrontend``'s
    interface; the state is the int64 noise estimate, on ``device``."""

    def __init__(self, step_ms: int = 10, device=None):
        self.step_ms = step_ms
        self.device = resolve_device(device)
        self.noise_estimate = torch.zeros(C.NUM_CHANNELS, dtype=torch.int64, device=self.device)

    def reset(self) -> None:
        self.noise_estimate.zero_()

    def process_window(self, samples) -> torch.Tensor:
        """One 480-sample int16 window -> 40 uint16 features."""
        window = torch.as_tensor(samples, device=self.device)
        feats, self.noise_estimate = frontend_frames_int(window[None], self.noise_estimate,
                                                         self.device)
        return feats[0]

    def process_clip(self, audio) -> torch.Tensor:
        """A clip -> [n_frames, 40] uint16 features, carrying the state."""
        frames = frame_audio(torch.as_tensor(audio, device=self.device), self.step_ms)
        feats, self.noise_estimate = frontend_frames_int(frames, self.noise_estimate, self.device)
        return feats


def generate_features_for_clip(audio_samples, step_ms: int = 10, device=None) -> torch.Tensor:
    """int16 (or float in [-1, 1]) PCM -> [n_frames, 40] float32 features on
    ``device`` by the integer-exact path (float = uint16 * 0.0390625)."""
    fe = MicroFrontendInt(step_ms=step_ms, device=device)
    return fe.process_clip(pcm_to_int16(audio_samples)).to(torch.float32) * C.FEATURE_SCALE
