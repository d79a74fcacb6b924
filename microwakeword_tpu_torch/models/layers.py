"""Streaming conv layers: the port of ``microwakeword_tpu/models/layers.py``.

Each layer is an ``nn.Module`` whose ``forward`` is the non-streaming valid
convolution over the full time axis, and whose ``step(x, ring)`` is the
streaming form: concatenate the ring buffer of past frames with the newest
ones, run the same valid op, and keep the last ``ring`` frames as the new
state.  Ring sizes follow the JAX layers (``conv_ring_size``).

Tensors at the public functions are [batch, time, channels], as in the JAX
package; the convolutions permute to [batch, channels, time] for
``F.conv1d``.  Weights are held in PyTorch's layouts (conv [out, in, k],
depthwise [C, 1, k], pointwise [out, in]); ``models/convert.py`` maps them to
and from the flax layouts.  Layers ported here are those MixedNet needs;
Delay, SubSpectralNorm, StreamAveragePooling and StreamConvTranspose wait
for the Inception slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Keras BatchNormalization epsilon (layers.py:40-41).
BN_EPSILON = 1e-3


def conv_ring_size(kernel_size: int, stride: int = 1, dilation: int = 1) -> int:
    """Ring-buffer frames for a strided valid conv (layers.py:44-46)."""
    return max(0, dilation * (kernel_size - 1) - (stride - 1))


def glorot_uniform(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """flax ``glorot_uniform`` over a kernel in flax layout (fans over the
    last two axes times the receptive field, the product of the others)."""
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def _with_ring(x: torch.Tensor, ring: torch.Tensor | None, size: int):
    """[ring, x] along time and the last ``size`` frames as the next ring
    (no ring when ``size`` is 0)."""
    if size == 0:
        return x, None
    x = torch.cat([ring, x], dim=1)
    return x, x[:, -size:]


class StreamConv(nn.Module):
    """Valid 1D convolution over time with an optional streaming ring buffer."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, use_bias: bool = False):
        super().__init__()
        self.in_features = in_features
        self.stride = stride
        self.dilation = dilation
        self.ring = conv_ring_size(kernel_size, stride, dilation)
        self.weight = nn.Parameter(torch.zeros(features, in_features, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        k = self.weight.shape[-1]
        kernel = glorot_uniform((k, self.in_features, self.weight.shape[0]), generator)
        with torch.no_grad():
            self.weight.copy_(kernel.permute(2, 1, 0))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                     stride=self.stride, dilation=self.dilation)
        return y.transpose(1, 2)

    def step(self, x: torch.Tensor, ring: torch.Tensor | None):
        x, ring = _with_ring(x, ring, self.ring)
        return self(x), ring


class MixConv(nn.Module):
    """Mixed-kernel depthwise conv over time (layers.py:93-173).

    One depthwise conv of width max(k) whose taps are masked so that group g
    sees only its newest k_g taps; the mask is applied in ``forward``, so
    nonzero masked taps in a converted kernel change nothing.
    """

    def __init__(self, channels: int, kernel_sizes: Sequence[int], use_bias: bool = False):
        super().__init__()
        self.in_features = channels
        self.kernel_sizes = tuple(kernel_sizes)
        kmax = max(self.kernel_sizes)
        self.splits = self.split_channels(channels, len(self.kernel_sizes))
        self.ring = kmax - 1
        mask = torch.zeros(channels, 1, kmax)
        start = 0
        for width, k in zip(self.splits, self.kernel_sizes):
            mask[start : start + width, :, kmax - k :] = 1.0
            start += width
        self.register_buffer("mask", mask, persistent=False)
        self.weight = nn.Parameter(torch.zeros(channels, 1, kmax))
        self.bias = nn.Parameter(torch.zeros(channels)) if use_bias else None

    @staticmethod
    def split_channels(total: int, groups: int) -> list[int]:
        """The first group takes the remainder (layers.py:117-121)."""
        split = [total // groups] * groups
        split[0] += total - sum(split)
        return split

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot per group on its true [k_g, 1, C_g] kernel (layers.py:134-149)."""
        kmax = max(self.kernel_sizes)
        with torch.no_grad():
            self.weight.zero_()
            start = 0
            for width, k in zip(self.splits, self.kernel_sizes):
                sub = glorot_uniform((k, 1, width), generator)  # flax [k, 1, C_g]
                self.weight[start : start + width, :, kmax - k :] = sub.permute(2, 1, 0)
                start += width
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.weight * self.mask, self.bias,
                     groups=self.in_features)
        return y.transpose(1, 2)

    def step(self, x: torch.Tensor, ring: torch.Tensor | None):
        x, ring = _with_ring(x, ring, self.ring)
        return self(x), ring


class StreamBuffer(nn.Module):
    """Identity ring buffer holding a sliding window of ``window`` frames.

    Non-streaming it is the identity.  Streaming, each step of
    ``frames_per_step`` frames returns the full [B, window, C] memory; the
    ring keeps ``window - frames_per_step`` frames (layers.py:176-202).
    """

    def __init__(self, channels: int, window: int, frames_per_step: int):
        super().__init__()
        self.in_features = channels
        self.window = window
        self.ring = max(0, window - frames_per_step)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def step(self, x: torch.Tensor, ring: torch.Tensor | None):
        if self.ring == 0:
            return x[:, -self.window :], None
        return _with_ring(x, ring, self.ring)


class BatchNorm(nn.Module):
    """Inference BatchNorm with flax semantics and Keras defaults:
    ``(x - mean) * (rsqrt(var + 1e-3) * scale) + bias`` over the last axis.

    The train-mode update (biased batch variance, momentum 0.99) waits for
    the training slice.
    """

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + BN_EPSILON) * self.scale
        return (x - self.mean) * mul + self.bias


class PointwiseConv(nn.Module):
    """1x1 conv over channels, a dense projection of [B, T, C]."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        kernel = glorot_uniform((self.in_features, self.weight.shape[0]), generator)
        with torch.no_grad():
            self.weight.copy_(kernel.T)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def align_time(residual: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Drop leading frames so ``residual`` matches ``target``'s time length."""
    drop = residual.shape[1] - target.shape[1]
    return residual[:, drop:] if drop > 0 else residual
