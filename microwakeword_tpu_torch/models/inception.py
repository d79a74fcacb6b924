"""Inception wake-word model: the port of ``microwakeword_tpu/models/inception.py``.

First valid convs with SubSpectralNorm -> blocks of three branches (1x1; 1x1
then a (dilated) k conv; 1x1 then two k convs) aligned by dropping leading
frames and concatenated, then a 1x1 conv -> tail sliding-window buffer ->
dropout -> Dense(1) -> sigmoid.

As ``models/mixednet.py``, one module runs ``forward`` over a full [B, T, 40]
spectrogram and ``step`` over the newest [B, 1, 40] frame with the ring
buffers in a flat cache dict.  Submodules carry flax's auto-names
(``ConvBnRelu_3.StreamConv_0``, ``ConvBnRelu_3.SubSpectralNorm_0.BatchNorm_0``,
``StreamBuffer_0``, ``Dense_0``), so ``models/convert.py`` maps the parameter
trees one to one.

The dropout draws its keep mask from an explicit ``torch.Generator`` (the
train step's), or takes a given mask: JAX draws its own with threefry, which
torch cannot reproduce, so the tests feed JAX's mask in.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from microwakeword_tpu_torch.models import layers as L
from microwakeword_tpu_torch.models.mixednet import Dense


@dataclasses.dataclass(frozen=True)
class InceptionConfig:
    """Hyperparameters; the same fields and defaults as the JAX config."""

    cnn1_filters: Sequence[int] = (24,)
    cnn1_kernel_sizes: Sequence[int] = (5,)
    cnn1_subspectral_groups: Sequence[int] = (4,)
    cnn2_filters1: Sequence[int] = (10, 10, 16)
    cnn2_filters2: Sequence[int] = (10, 10, 16)
    cnn2_kernel_sizes: Sequence[int] = (5, 5, 5)
    cnn2_subspectral_groups: Sequence[int] = (1, 1, 1)
    cnn2_dilation: Sequence[int] = (1, 1, 1)
    dropout: float = 0.2
    spectrogram_length: int = 124
    stride: int = 1  # streaming frames per step; always 1 for Inception


def spectrogram_slices_dropped(cfg: InceptionConfig) -> int:
    """Input frames consumed by the valid convs (inception.py:42-49)."""
    dropped = sum(k - 1 for k in cfg.cnn1_kernel_sizes)
    for k, d in zip(cfg.cnn2_kernel_sizes, cfg.cnn2_dilation):
        dropped += 2 * d * (k - 1)
    return dropped


def tail_length(cfg: InceptionConfig) -> int:
    return cfg.spectrogram_length - spectrogram_slices_dropped(cfg)


def draw_keep_mask(shape, keep: float, generator: torch.Generator,
                   device: torch.device) -> torch.Tensor:
    """A boolean keep mask, each entry kept with probability ``keep``, drawn
    on ``device`` from ``generator`` (no host sync)."""
    return torch.rand(shape, generator=generator, device=device) < keep


class ConvBnRelu(nn.Module):
    """Valid conv (1x1 or a (dilated) k conv) + SubSpectralNorm + relu
    (inception.py:57-86)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 dilation: int = 1, sub_groups: int = 1):
        super().__init__()
        self.conv_name = "PointwiseConv_0" if kernel_size == 1 else "StreamConv_0"
        if kernel_size == 1:
            self.PointwiseConv_0 = L.PointwiseConv(in_features, features)
        else:
            self.StreamConv_0 = L.StreamConv(in_features, features, kernel_size,
                                             dilation=dilation)
        self.SubSpectralNorm_0 = L.SubSpectralNorm(features, sub_groups)

    def run(self, x: torch.Tensor, prefix: str, cache, new_cache) -> torch.Tensor:
        conv = self.get_submodule(self.conv_name)
        x = L.stream_apply(conv, f"{prefix}/{self.conv_name}", x, cache, new_cache)
        return torch.relu(self.SubSpectralNorm_0(x))


class Inception(L.StreamingModel):
    def __init__(self, cfg: InceptionConfig, input_features: int = 40):
        super().__init__()
        self.cfg = cfg
        count = 0

        def unit(in_features: int, features: int, kernel_size: int = 1, dilation: int = 1,
                 sub_groups: int = 1) -> str:
            nonlocal count
            name = f"ConvBnRelu_{count}"
            count += 1
            self.add_module(name, ConvBnRelu(in_features, features, kernel_size, dilation,
                                             sub_groups))
            return name

        c = input_features
        self.first = []
        for filters, k, groups in zip(cfg.cnn1_filters, cfg.cnn1_kernel_sizes,
                                      cfg.cnn1_subspectral_groups):
            self.first.append(unit(c, filters, k, sub_groups=groups))
            c = filters
        # blocks: ([b1], [b2 1x1, b2 k], [b3 1x1, b3 k, b3 k], post-concat 1x1)
        self.blocks = []
        for f1, f2, k, groups, dil in zip(cfg.cnn2_filters1, cfg.cnn2_filters2,
                                          cfg.cnn2_kernel_sizes, cfg.cnn2_subspectral_groups,
                                          cfg.cnn2_dilation):
            b1 = [unit(c, f1, sub_groups=groups)]
            b2 = [unit(c, f1, sub_groups=groups), unit(f1, f1, k, dil, groups)]
            b3 = [unit(c, f1, sub_groups=groups), unit(f1, f1, k, dil, groups),
                  unit(f1, f1, k, dil, groups)]
            post = unit(3 * f1, f2)  # sub_groups 1 after the concat
            self.blocks.append((b1, b2, b3, post))
            c = f2
        t_tail = tail_length(cfg)
        if t_tail < 1:
            raise ValueError(
                f"spectrogram_length {cfg.spectrogram_length} too short for this architecture "
                f"(tail length {t_tail})")
        self.StreamBuffer_0 = L.StreamBuffer(c, t_tail, 1)
        self.Dense_0 = Dense(c * t_tail, 1)

    def _branch(self, names, x, cache, new_cache) -> torch.Tensor:
        for name in names:
            x = self.get_submodule(name).run(x, name, cache, new_cache)
        return x

    def _run(self, x: torch.Tensor, cache, new_cache, dropout=None) -> torch.Tensor:
        x = self._branch(self.first, x, cache, new_cache)
        for b1, b2, b3, post in self.blocks:
            y3 = self._branch(b3, x, cache, new_cache)
            y1 = L.align_time(self._branch(b1, x, cache, new_cache), y3)
            y2 = L.align_time(self._branch(b2, x, cache, new_cache), y3)
            x = self._branch([post], torch.cat([y1, y2, y3], dim=-1), cache, new_cache)
        x = L.stream_apply(self.StreamBuffer_0, "StreamBuffer_0", x, cache, new_cache)
        x = x.reshape(x.shape[0], -1)  # [B, T, C] flattens time-major
        if self.training and self.cfg.dropout > 0:
            x = self._dropout(x, dropout)
        return torch.sigmoid(self.Dense_0(x))

    def keep_mask(self, rows: int, generator: torch.Generator) -> torch.Tensor | None:
        """[rows, tail * C]: the dropout acts on the flattened tail that
        feeds ``Dense_0``."""
        if self.cfg.dropout <= 0:
            return None
        weight = self.Dense_0.weight
        return draw_keep_mask((rows, weight.shape[1]), 1.0 - self.cfg.dropout, generator,
                              weight.device)

    def _dropout(self, x: torch.Tensor, dropout) -> torch.Tensor:
        """flax ``nn.Dropout``: ``where(keep, x / keep_prob, 0)``."""
        keep_prob = 1.0 - self.cfg.dropout
        if isinstance(dropout, torch.Generator):
            mask = self.keep_mask(x.shape[0], dropout)
        elif isinstance(dropout, torch.Tensor):
            mask = dropout.to(device=x.device, dtype=torch.bool).reshape(x.shape)
        else:
            raise ValueError(
                "Inception in train mode needs its dropout's generator or keep mask")
        return torch.where(mask, x / keep_prob, torch.zeros_like(x))

    def forward(self, x: torch.Tensor, dropout=None) -> torch.Tensor:
        """[B, T, 40] spectrogram -> [B, 1] wake probability.  In train mode
        ``dropout`` is the generator the keep mask is drawn from, or a
        boolean keep mask [B, tail * C]; eval mode applies no dropout."""
        return self._run(x, None, None, dropout)
