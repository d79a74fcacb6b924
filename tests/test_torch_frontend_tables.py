"""The host tables the frontend kernel reads, and its algorithm run on the CPU.

The CUDA kernel (``csrc/frontend.cu``) cannot run here, so these tests hold
what it is built from: the tables of ``kernel.host_tables`` against their
float64 definitions, a numpy run of its FFT (the 512-point real frame packed
into 256 complex values, two passes of 16-point FFTs, the split step) against
``np.fft.rfft``, and float32 runs of its tile-carry EMA and of the whole
kernel against the plain version under the Q6 gate.
"""

import numpy as np
import pytest
import torch

from microwakeword_tpu_torch.frontend import constants as C
from microwakeword_tpu_torch.frontend import gate, kernel, plain

torch.set_num_threads(2)


def _f32_tables():
    return {k: v.numpy() for k, v in kernel.device_tables(torch.device("cpu")).items()}


def _complex(pairs: np.ndarray) -> np.ndarray:
    return pairs[..., 0] + 1j * pairs[..., 1]


def _dft4(a, b, c, d):
    t0, t1, t2, t3 = a + c, a - c, b + d, b - d
    return t0 + t2, t1 - 1j * t3, t0 - t2, t1 + 1j * t3


def _fft16(v, fft16, cdt):
    """The kernel's fft16 over the last axis: radix 4 x 4 with its twiddles."""
    c8, s8, r2 = (float(x) for x in fft16)
    v = [v[..., i] for i in range(16)]
    for b in range(4):
        v[b], v[4 + b], v[8 + b], v[12 + b] = _dft4(v[b], v[4 + b], v[8 + b], v[12 + b])
    w = {1: complex(c8, -s8), 2: complex(r2, -r2), 3: complex(s8, -c8),
         4: -1j, 6: complex(-r2, -r2), 9: complex(-c8, s8)}
    for b in range(1, 4):
        for c in range(1, 4):
            v[4 * c + b] = v[4 * c + b] * cdt(w[b * c])
    for c in range(4):
        v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3] = _dft4(*v[4 * c : 4 * c + 4])
    return np.stack([v[4 * (k % 4) + k // 4] for k in range(16)], axis=-1)


def _kernel_rfft(frames: np.ndarray, tables: dict) -> np.ndarray:
    """[..., 480] frames -> [..., 257] bins, as launch A computes them, in the
    tables' precision (float64 or float32)."""
    real = tables["window"].dtype.type
    cdt = np.complex128 if real is np.float64 else np.complex64
    x = np.zeros(frames.shape[:-1] + (C.FFT_SIZE,), real)
    x[..., : C.WINDOW_SAMPLES] = frames.astype(real) * tables["window"]
    z = (x[..., 0::2] + 1j * x[..., 1::2]).astype(cdt)
    # pass 1, per n2: FFT over n1 of z[16 n1 + n2], times W256^(n2 k1)
    y = _fft16(z.reshape(z.shape[:-1] + (16, 16)).swapaxes(-1, -2), tables["fft16"], cdt)
    y = y * _complex(tables["tw256"]).astype(cdt).T  # y[..., n2, k1]
    # pass 2, per k1: FFT over n2 -> Z[k1 + 16 k2]
    zk = _fft16(y.swapaxes(-1, -2), tables["fft16"], cdt)  # [..., k1, k2]
    zz = zk.swapaxes(-1, -2).reshape(z.shape)
    k = np.arange(C.N_FFT_BINS)
    a, b = zz[..., k % 256], zz[..., (256 - k) % 256]
    even = ((a.real + b.real) * real(0.5)) + 1j * ((a.imag - b.imag) * real(0.5))
    odd = ((a.imag + b.imag) * real(0.5)) + 1j * ((b.real - a.real) * real(0.5))
    return (even.astype(cdt) + odd.astype(cdt) * _complex(tables["tw512"]).astype(cdt)).astype(cdt)


def _kernel_sf(frames: np.ndarray) -> np.ndarray:
    """Launch A's scaled filterbank in float32: FFT, energy, the sparse mel
    taps in ascending bin order, sqrt / 8."""
    t = _f32_tables()
    bins = _kernel_rfft(frames, t)
    energy = bins.real * bins.real + bins.imag * bins.imag
    sf = np.zeros(frames.shape[:-1] + (C.NUM_CHANNELS,), np.float32)
    for c in range(C.NUM_CHANNELS):
        o0, o1, first = t["mel_offset"][c], t["mel_offset"][c + 1], t["mel_first"][c]
        acc = np.zeros(frames.shape[:-1], np.float32)
        for o in range(o0, o1):
            acc = (energy[..., first + o - o0].astype(np.float64) * t["mel_weights"][o]
                   + acc).astype(np.float32)  # fmaf: one rounding
        sf[..., c] = np.sqrt(np.maximum(acc, 0)) / np.float32(8.0)
    return sf


def _tile_carry_ema(sf: torch.Tensor) -> torch.Tensor:
    """Launch B's estimates in float32, from launch A's tile ends: each end is
    sum_h (s x_h) (1-s)^(nt-1-h) over a tile's nt hops, summed as A's warp
    butterfly does; the carry is launch S's scan carry_j = D carry_{j-1} +
    end_{j-1}, sum_{i<j} D^(j-1-i) end_i, then each tile
    walks its hops from its carry."""
    tab = kernel.device_tables(torch.device("cpu"))
    parity = torch.arange(C.NUM_CHANNELS) % 2
    s = torch.from_numpy(C.SMOOTHING.astype(np.float32))
    keep = 1.0 - s
    decay = tab["decay"][parity]
    t, lanes = sf.shape[-2], torch.arange(kernel.TILE)
    starts = range(0, t, kernel.TILE)
    ends = []
    for t0 in starts:
        nt = min(kernel.TILE, t - t0)
        term = torch.zeros(sf.shape[:-2] + (kernel.TILE, C.NUM_CHANNELS))
        powers = tab["ema_powers"][parity][:, nt - 1 - torch.arange(nt)].T  # [nt, 40]
        term[..., :nt, :] = (s * sf[..., t0 : t0 + nt, :]) * powers
        for d in (16, 8, 4, 2, 1):
            term = term + term[..., lanes ^ d, :]
        ends.append(term[..., 0, :])
    out = torch.empty_like(sf)
    carry = torch.zeros_like(sf[..., 0, :])
    for j, t0 in enumerate(starts):
        est = carry
        for i in range(t0, min(t0 + kernel.TILE, t)):
            est = keep * est + s * sf[..., i, :]
            out[..., i, :] = est
        carry = decay * carry + ends[j]
    return out


def test_sparse_mel_rebuilds_the_dense_matrix():
    t = _f32_tables()
    dense = np.zeros((C.N_FFT_BINS, C.NUM_CHANNELS), np.float32)
    for c in range(C.NUM_CHANNELS):
        o0, o1 = t["mel_offset"][c], t["mel_offset"][c + 1]
        dense[t["mel_first"][c] : t["mel_first"][c] + o1 - o0, c] = t["mel_weights"][o0:o1]
    np.testing.assert_array_equal(dense, C.mel_filterbank_matrix().astype(np.float32))
    np.testing.assert_array_equal(dense, plain._dft_mel_constants()[2])
    assert t["mel_offset"][-1] == np.count_nonzero(dense) == 456
    assert (np.count_nonzero(dense, axis=1) <= 2).all()  # each bin feeds <= 2 channels
    slots = t["mel_slots"]  # every channel once, at most 29 taps per thread
    assert sorted(slots[slots >= 0]) == list(range(C.NUM_CHANNELS))
    taps = np.diff(t["mel_offset"])
    assert max(taps[slots[:, j][slots[:, j] >= 0]].sum() for j in range(16)) == 29


@pytest.mark.parametrize("name", ["window", "fft16", "tw256", "tw512", "ema_powers"])
def test_float32_tables_are_their_float64_values_cast(name):
    k1, n2 = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    ang256 = 2 * np.pi * (k1 * n2) / 256
    ang512 = 2 * np.pi * np.arange(257) / 512
    want = {
        "window": 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(480) + 0.5) / 480),
        "fft16": np.array([np.cos(np.pi / 8), np.sin(np.pi / 8), np.sqrt(0.5)]),
        "tw256": np.stack([np.cos(ang256), -np.sin(ang256)], axis=-1),
        "tw512": np.stack([np.cos(ang512), -np.sin(ang512)], axis=-1),
        "ema_powers": np.array([[(1 - s) ** m for m in range(32)] for s in (0.025, 0.06)]),
    }[name]
    got = _f32_tables()[name]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))
    if name == "fft16":  # the kernel takes W16^3, ^6, ^9 from these three
        c8, s8, r2 = got
        assert np.float32(np.cos(3 * np.pi / 8)) == s8
        assert np.float32(np.cos(9 * np.pi / 8)) == -c8
        assert np.float32(-np.sin(6 * np.pi / 8)) == -r2


def test_decay_table_is_one_minus_s_to_the_tile():
    decay = _f32_tables()["decay"]
    for parity, s in enumerate((C.EVEN_SMOOTHING, C.ODD_SMOOTHING)):
        assert decay[parity] == np.float32(np.prod(np.full(kernel.TILE, 1.0 - s)))
    assert decay.dtype == np.float32


@pytest.mark.parametrize("kind", ["noise", "full-scale", "tone"])
def test_packed_fft_and_split_step_match_rfft(kind):
    rng = np.random.default_rng(11)
    if kind == "noise":
        frames = rng.integers(-8000, 8000, (6, 480)).astype(np.int16)
    elif kind == "full-scale":
        frames = rng.choice(np.array([-32767, 32767], np.int16), (6, 480))
    else:
        t = np.arange(480) / C.SAMPLE_RATE
        frames = np.round(30000 * np.sin(2 * np.pi * np.array([[250.0], [3300.0]]) * t)).astype(np.int16)
    got = _kernel_rfft(frames, kernel.host_tables())
    want = np.fft.rfft(frames * C.hann_window(), n=C.FFT_SIZE)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_tile_carry_ema_passes_the_gate_against_plain():
    """T = 1130: 36 tiles, and above plain's 1,024-frame EMA chunk."""
    rng = np.random.default_rng(12)
    audio = rng.integers(-12000, 12000, (2, 480 + 160 * 1129)).astype(np.int16)
    sf = plain.scaled_filterbank(plain.frame_audio(torch.from_numpy(audio).float(), 10))
    assert sf.shape[1] == 1130
    want, _ = plain.frontend_streaming(sf, sf.new_zeros(2, C.NUM_CHANNELS))
    got = plain._agc_output(sf, _tile_carry_ema(sf)) * C.FEATURE_SCALE
    gate.assert_q6_gate(got.numpy(), want.numpy())


@pytest.mark.parametrize("kind", ["noise", "full-scale noise", "pure tones"])
def test_float32_kernel_algorithm_passes_the_gate_against_plain(kind):
    """Launch A's FFT and sparse mel, then launch B's tile carry, in float32."""
    rng = np.random.default_rng(13)
    n = 480 + 160 * 99  # 100 frames: 4 tiles, the last one ragged
    if kind == "noise":
        audio = rng.integers(-8000, 8000, (2, n)).astype(np.int16)
    elif kind == "full-scale noise":
        audio = rng.integers(-32767, 32768, (2, n)).astype(np.int16)
    else:
        t = np.arange(n) / C.SAMPLE_RATE
        audio = np.round(30000 * np.sin(2 * np.pi * np.array([[1000.0], [7000.0]]) * t)).astype(np.int16)
    frames = plain.frame_audio(torch.from_numpy(audio).float(), 10).numpy()
    sf = torch.from_numpy(_kernel_sf(frames))
    got = plain._agc_output(sf, _tile_carry_ema(sf)) * C.FEATURE_SCALE
    res = gate.assert_q6_gate(got.numpy(), plain.frontend_batch(torch.from_numpy(audio)).numpy())
    assert res.cells == 2 * 100 * 40
