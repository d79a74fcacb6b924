"""Streaming conv layers: the port of ``microwakeword_tpu/models/layers.py``.

Each layer is an ``nn.Module`` whose ``forward`` is the non-streaming valid
convolution over the full time axis, and whose ``step(x, ring)`` is the
streaming form: concatenate the ring buffer of past frames with the newest
ones, run the same valid op, and keep the last ``ring`` frames as the new
state.  Ring sizes follow the JAX layers (``conv_ring_size``).

Tensors at the public functions are [batch, time, channels], as in the JAX
package; the convolutions permute to [batch, channels, time] for
``F.conv1d``.  Weights are held in PyTorch's layouts (conv [out, in, k],
depthwise [C, 1, k], pointwise [out, in], transposed conv [in, out, k]);
``models/convert.py`` maps them to and from the flax layouts.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Keras BatchNormalization momentum and epsilon (layers.py:40-41).
BN_MOMENTUM = 0.99
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


def stream_apply(layer: nn.Module, name: str, x: torch.Tensor, cache, new_cache) -> torch.Tensor:
    """``layer(x)`` when ``cache`` is None, else its streaming step with the
    ring under ``name/ring`` in ``cache``; the step's new ring goes into
    ``new_cache``."""
    if cache is None:
        return layer(x)
    key = f"{name}/ring"
    y, ring = layer.step(x, cache.get(key))
    if ring is not None:
        new_cache[key] = ring
    return y


class StreamingModel(nn.Module):
    """What the model families share around their graph, ``_run(x, cache,
    new_cache)``: the non-streaming pass when ``cache`` is None, else one
    streaming step that reads its rings from ``cache`` and writes the next
    ones into ``new_cache``."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot kernels, zero biases, BN scale 1 / bias 0 / mean 0 / var 1."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def keep_mask(self, rows: int, generator: torch.Generator) -> torch.Tensor | None:
        """The keep mask of the model's dropout for ``rows`` rows, drawn from
        ``generator`` as its train-mode forward draws it; None: no dropout."""
        return None

    def step(self, x: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        """Newest [B, stride, 40] slices -> ([B, 1] probs, new cache)."""
        new_cache = {}
        probs = self._run(x, cache, new_cache)
        return probs, new_cache

    def cache_shapes(self, batch_size: int) -> dict:
        """{"<module path>/ring": (B, ring, channels)} for every layer with a
        ring (the JAX cache tree's keys, flattened)."""
        shapes = {}
        for path, module in self.named_modules():
            if getattr(module, "ring", 0) > 0:
                channels = getattr(module, "ring_channels", getattr(module, "in_features", None))
                shapes[path.replace(".", "/") + "/ring"] = (batch_size, module.ring, channels)
        return shapes


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


class Delay(nn.Module):
    """FIFO delay line (layers.py:205-232): streaming emits the frames of
    ``delay`` steps ago (zeros at first); non-streaming it is the identity, or
    with ``also_in_non_streaming`` a left zero pad cropped to the input's
    length."""

    def __init__(self, channels: int, delay: int, also_in_non_streaming: bool = False):
        super().__init__()
        self.in_features = channels
        self.ring = max(0, delay)
        self.also_in_non_streaming = also_in_non_streaming

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ring == 0 or not self.also_in_non_streaming:
            return x
        return F.pad(x, (0, 0, self.ring, 0))[:, : x.shape[1]]

    def step(self, x: torch.Tensor, ring: torch.Tensor | None):
        if self.ring == 0:
            return x, None
        memory, ring = _with_ring(x, ring, self.ring)
        return memory[:, : x.shape[1]], ring


class BatchNorm(nn.Module):
    """BatchNorm with flax semantics and Keras defaults over the last axis:
    ``(x - mean) * (rsqrt(var + 1e-3) * scale) + bias``.

    ``eval()`` normalises with the running statistics.  ``train()`` takes
    the statistics of the batch over every axis but the last (batch and time
    together) with flax's fast variance, ``max(0, E[x^2] - E[x]^2)``, and
    updates the running ones as ``0.99 * running + 0.01 * batch`` with that
    biased variance (``torch.nn.BatchNorm1d`` uses the unbiased one).

    ``stats_reduce``, where a data-parallel train step sets it
    (``parallel/train_step.py``), maps this rank's ``E[x]`` and ``E[x^2]``
    to the global batch's, so that the statistics are the global batch's as
    in the JAX package's sharded step.
    """

    stats_reduce = None

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
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean, mean_sq = x.mean(dim=dims), (x * x).mean(dim=dims)
            if self.stats_reduce is not None:
                mean, mean_sq = self.stats_reduce(mean, mean_sq)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1.0 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        return (x - mean) * mul + self.bias


class SubSpectralNorm(nn.Module):
    """BatchNorm over channel sub-groups (layers.py:249-276).

    The [B, T, C] input is viewed as [B, T, C/g, g] and normalised by a
    ``BatchNorm`` of g features, so channel c uses statistics and parameters
    ``c % g``; with g = 1 it is a ``BatchNorm`` of C features.  Train mode
    takes the statistics over B, T and C/g (``BatchNorm``'s rule over every
    axis but the last).
    """

    def __init__(self, channels: int, sub_groups: int):
        super().__init__()
        if channels % sub_groups:
            raise ValueError(f"channels {channels} not divisible by sub_groups {sub_groups}")
        self.sub_groups = sub_groups
        self.BatchNorm_0 = BatchNorm(channels if sub_groups == 1 else sub_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.sub_groups
        if g == 1:
            return self.BatchNorm_0(x)
        b, t, c = x.shape
        return self.BatchNorm_0(x.reshape(b, t, c // g, g)).reshape(b, t, c)


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

    def step(self, x: torch.Tensor, ring: torch.Tensor | None):
        return self(x), None  # frame by frame: no ring


class StreamAveragePooling(nn.Module):
    """Average pooling over time as a depthwise conv of fixed 1/k weights
    (layers.py:294-332); it has no parameter."""

    def __init__(self, channels: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.in_features = channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.ring = conv_ring_size(kernel_size, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.in_features
        weight = torch.full((c, 1, self.kernel_size), 1.0 / self.kernel_size,
                            dtype=x.dtype, device=x.device)
        y = F.conv1d(x.transpose(1, 2), weight, stride=self.stride, groups=c)
        return y.transpose(1, 2)

    def step(self, x: torch.Tensor, ring: torch.Tensor | None):
        x, ring = _with_ring(x, ring, self.ring)
        return self(x), ring


class StreamConvTranspose(nn.Module):
    """Transposed 1D conv over time (layers.py:335-398): ``y[t * stride + j]
    += x[t] @ W[j]``.

    Non-streaming, the output is cropped to T * stride frames
    (``crop_output``; off, all (T - 1) * stride + k frames are kept).  A
    streaming step of m frames emits m * stride frames and carries the
    trailing k - stride frames of partial sums, which the next step adds to
    its first frames (overlap-add); that needs k >= stride.  The bias is
    added to each emitted frame.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 use_bias: bool = False, crop_output: bool = True):
        super().__init__()
        self.in_features = in_features
        self.ring_channels = features
        self.kernel_size = kernel_size
        self.stride = stride
        self.crop_output = crop_output
        self.ring = max(kernel_size - stride, 0)
        self.weight = nn.Parameter(torch.zeros(in_features, features, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        kernel = glorot_uniform((self.kernel_size, self.ring_channels, self.in_features), generator)
        with torch.no_grad():
            self.weight.copy_(kernel.permute(2, 1, 0))
            if self.bias is not None:
                self.bias.zero_()

    def _overlap_add(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x.transpose(1, 2), self.weight, stride=self.stride).transpose(1, 2)

    def _biased(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._overlap_add(x)
        if self.crop_output:
            y = y[:, : x.shape[1] * self.stride]
        return self._biased(y)

    def step(self, x: torch.Tensor, ring: torch.Tensor | None):
        if self.kernel_size < self.stride:
            raise ValueError(
                f"streaming StreamConvTranspose requires kernel_size ({self.kernel_size}) >= "
                f"stride ({self.stride}); smaller kernels would emit fewer than stride frames "
                "per step")
        y = self._overlap_add(x)
        emit = x.shape[1] * self.stride
        if self.ring == 0:
            return self._biased(y[:, :emit]), None
        y = torch.cat([y[:, : self.ring] + ring, y[:, self.ring :]], dim=1)
        return self._biased(y[:, :emit]), y[:, emit:]


def align_time(residual: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Drop leading frames so ``residual`` matches ``target``'s time length."""
    drop = residual.shape[1] - target.shape[1]
    return residual[:, drop:] if drop > 0 else residual
