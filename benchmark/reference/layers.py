"""Plain building blocks of the two families' references: valid 1-D
convolutions over [B, T, C] with optional left zero padding (a streamed
layer's ring buffer starts at zero, so a stream over T frames is the valid
layer over its input with ``ring`` zero frames in front), the Keras/flax
BatchNorm, and the sliding window of the tail.  Imports nothing of the
program."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPSILON = 1e-3


def left_pad(x: torch.Tensor, frames: int) -> torch.Tensor:
    return F.pad(x, (0, 0, frames, 0)) if frames > 0 else x


def conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, dilation: int = 1,
         groups: int = 1) -> torch.Tensor:
    """Valid conv over time: x [B, T, C_in], weight [C_out, C_in / groups, k]."""
    return F.conv1d(x.transpose(1, 2), weight, stride=stride, dilation=dilation,
                    groups=groups).transpose(1, 2)


def batch_norm(x: torch.Tensor, scale, bias, mean, var, train: bool) -> torch.Tensor:
    """Normalises the last axis; in training with the batch's statistics
    over every other axis, the variance ``E[x^2] - E[x]^2`` clamped at 0
    (flax's), else with the running ones."""
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + BN_EPSILON) * scale) + bias


def tail_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, S, C] frames -> [B, S, window * C]: at each step the newest
    ``window`` frames, time-major, with zeros before the first."""
    padded = left_pad(x, window - 1)
    return padded.unfold(1, window, 1).transpose(2, 3).reshape(x.shape[0], x.shape[1], -1)
