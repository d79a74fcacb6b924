"""Operations and bytes of the micro-frontend's function (the frontend
kernel, ``csrc/frontend.cu``: launches A, S and B), and its roofline bound.

The least FP32 operations per hop: the window (480 multiplies); the
512-point real FFT as a packed 256-point complex split-radix FFT
(4 M log2 M - 6 M + 8 operations, M = 256) and its split step to 257 bins (14
for each pair of bins k, 256 - k with 0 < k < 128, the halvings folded into
the twiddles, and 2 for bins 0 and 256); the energy of 257 bins (3 each);
the mel filters' nonzero taps (2 each); and per feature cell sqrt and / 8
(2), the noise estimate (3) and the gain, floor and log stage (24).  That is
11,767 a hop.  Bytes: the PCM read once and the float32 features written
once.
"""

from __future__ import annotations

import math

from benchmark.counts.peaks import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
from benchmark.reference import frontend as RF

CELL_FLOPS = 2 + 3 + 24
# the __global__ functions of the kernel's three launches
KERNELS = ("filterbank_kernel", "carry_scan_kernel", "ema_agc_kernel")


def flops_per_hop() -> float:
    m = RF.FFT // 2
    fft = 4 * m * math.log2(m) - 6 * m + 8 + 14 * (m // 2 - 1) + 2
    taps = int((RF.mel_weights() != 0).sum())
    return float(RF.WINDOW + fft + 3 * RF.BINS + 2 * taps + CELL_FLOPS * RF.CHANNELS)


def work(batch: int, samples: int, step_ms: int, sample_bytes: int = 2) -> tuple[float, float]:
    """(FP32 operations, bytes) of one call on [batch, samples] PCM."""
    frames = RF.num_frames(samples, step_ms)
    flops = batch * frames * flops_per_hop()
    nbytes = batch * samples * sample_bytes + batch * frames * RF.CHANNELS * 4
    return flops, float(nbytes)


def bound_s(batch: int, samples: int, step_ms: int) -> tuple[float, str]:
    """The least seconds for one call on this card, and what bounds it."""
    flops, nbytes = work(batch, samples, step_ms)
    ops_s, bytes_s = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
