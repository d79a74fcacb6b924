"""Inputs made from the run's seed: PCM clips, spectrogram corpora and model
weights.  Everything is drawn on the run's device from a ``torch.Generator``
in a few large calls, and the same seed gives the same inputs.  The program
and the reference are handed the same inputs."""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000
# tone bands of the synthetic speech bursts (Hz): positives high, negatives low
BANDS = {True: (2000.0, 2400.0), False: (200.0, 800.0)}
CHUNK_ROWS = 256  # clips drawn per call, so that float32 temporaries stay small


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def pcm_clips(gen: torch.Generator, count: int, samples: int, positive: bool,
              device) -> torch.Tensor:
    """[count, samples] int16 clips: Gaussian noise at a level per clip
    (100-3000) and one tone burst of 0.4-0.8 s (amplitude 2000-12000) in the
    class's band, at a place per clip."""
    lo, hi = BANDS[bool(positive)]
    t = torch.arange(samples, device=device, dtype=torch.float32) / SAMPLE_RATE
    out = torch.empty((count, samples), dtype=torch.int16, device=device)
    dur = samples / SAMPLE_RATE
    for first in range(0, count, CHUNK_ROWS):
        n = min(CHUNK_ROWS, count - first)
        u = torch.rand((n, 5), generator=gen, device=device)
        level = 100.0 + 2900.0 * u[:, 0:1]
        freq = lo + (hi - lo) * u[:, 1:2]
        amp = 2000.0 + 10000.0 * u[:, 2:3]
        length = 0.4 + 0.4 * u[:, 3:4]
        start = (dur - length).clamp(min=0.0) * u[:, 4:5]
        on = (t >= start) & (t < start + length)
        x = torch.randn((n, samples), generator=gen, device=device) * level
        x += amp * torch.sin(2.0 * math.pi * freq * t) * on
        out[first:first + n] = torch.round(x.clamp(-32768.0, 32767.0)).to(torch.int16)
    return out


def spectrogram_corpus(gen: torch.Generator, count: int, frames: tuple, positive: bool,
                       features: int, device) -> tuple[np.ndarray, np.ndarray]:
    """A ragged corpus of ``count`` uint16 feature clips with lengths drawn
    uniformly from ``frames`` = (least, most): (data [total, features]
    uint16, offsets [count + 1] int64).  Values lie in the range the
    frontend emits (0-380 of its 0-665): noise 0-80 in every channel and 300
    more in the upper half of the channels for positives, the lower half for
    negatives, as the phase 6 store of ``chip_smoke.py``."""
    lo, hi = frames
    lengths = torch.randint(lo, hi + 1, (count,), generator=gen, device=device)
    total = int(lengths.sum())
    data = torch.randint(0, 81, (total, features), generator=gen, device=device,
                         dtype=torch.int32)
    half = features // 2
    if positive:
        data[:, half:] += 300
    else:
        data[:, :half] += 300
    offsets = np.concatenate([[0], np.cumsum(lengths.cpu().numpy())]).astype(np.int64)
    return data.to(torch.int32).cpu().numpy().astype(np.uint16), offsets


def weights(shapes: dict, gen: torch.Generator, device, serving: bool) -> dict:
    """A state dict for ``shapes`` (name -> shape, in the model's state-dict
    order): kernels (``*.weight``) Glorot-uniform over the fans of their
    PyTorch layout ([out, in, k] or [out, in]), biases 0, BatchNorm scales 1
    and biases 0.  The running statistics are the identity for training;
    for serving (``serving``) they are drawn, means N(0, 0.2) and variances
    U(0.02, 0.2), which widens the probabilities so that accepts fire.  Two
    draws in all, float32 on ``device``."""
    kernels = {k: s for k, s in shapes.items() if k.endswith(".weight")}
    flat = torch.rand(sum(math.prod(s) for s in kernels.values()), generator=gen, device=device)
    stats = {k: s for k, s in shapes.items() if k.endswith((".mean", ".var"))}
    drawn = torch.rand(sum(math.prod(s) for s in stats.values()) * 2, generator=gen,
                       device=device)
    state, at, at_stats = {}, 0, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        if name in kernels:
            receptive = math.prod(shape[2:])
            limit = math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
            state[name] = ((2.0 * flat[at:at + n] - 1.0) * limit).reshape(shape)
            at += n
        elif name.endswith(".scale"):
            state[name] = torch.ones(shape, device=device)
        elif name.endswith(".mean"):
            u1, u2 = drawn[at_stats:at_stats + n], drawn[at_stats + n:at_stats + 2 * n]
            normal = torch.sqrt(-2.0 * torch.log(u1.clamp(min=1e-12))) * torch.cos(2 * math.pi * u2)
            state[name] = (0.2 * normal).reshape(shape) if serving else torch.zeros(shape, device=device)
            at_stats += 2 * n
        elif name.endswith(".var"):
            u = drawn[at_stats:at_stats + n]
            state[name] = (0.02 + 0.18 * u).reshape(shape) if serving else torch.ones(shape, device=device)
            at_stats += 2 * n
        else:  # biases
            state[name] = torch.zeros(shape, device=device)
    return state
