"""MixedNet wake-word model: the port of ``microwakeword_tpu/models/mixednet.py``.

Optional first strided valid conv -> blocks of [MixConv -> 1x1 conv -> BN ->
optional 1x1-conv residual -> relu] -> tail sliding-window buffer -> optional
spatial attention / pooling -> time-major flatten -> Dense(1) -> sigmoid.

One module runs both modes: ``forward(x)`` over a full [B, T, 40]
spectrogram, and ``step(x, cache)`` over the newest [B, stride, 40] slices
with the ring buffers in ``cache``, a flat dict keyed like the JAX cache tree
(``"MixConv_0/ring"`` -> [B, ring, C]).  Submodules carry the names flax
gives the JAX modules (``StreamConv_0``, ``MixConv_2``, ``BatchNorm_1`` ...),
so ``models/convert.py`` maps the two parameter trees by name.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import torch
from torch import nn

from microwakeword_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MixedNetConfig:
    """Hyperparameters; the same fields and defaults as the JAX config."""

    pointwise_filters: Sequence[int] = (48, 48, 48, 48)
    repeat_in_block: Sequence[int] = (1, 1, 1, 1)
    mixconv_kernel_sizes: Sequence[Sequence[int]] = ((5,), (9,), (13,), (21,))
    residual_connection: Sequence[bool] = (False, False, False, False)
    first_conv_filters: int = 32
    first_conv_kernel_size: int = 3
    stride: int = 1
    max_pool: bool = False
    pooled: bool = False
    spatial_attention: bool = False
    mixconv_bias: bool = False
    spectrogram_length: int = 194

    def __post_init__(self):
        n = len(self.pointwise_filters)
        for name in ("repeat_in_block", "mixconv_kernel_sizes", "residual_connection"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"{name} must have {n} entries")
        t = tail_length(self)
        if t < 1:
            raise ValueError(
                f"spectrogram_length {self.spectrogram_length} too short for "
                f"this architecture (tail length {t}); needs at least "
                f"{self.spectrogram_length - t + 1} frames"
            )


def spectrogram_slices_dropped(cfg: MixedNetConfig) -> int:
    """Input slices consumed by valid padding (mixednet.py:58-65)."""
    dropped = 0
    if cfg.first_conv_filters > 0:
        dropped += cfg.first_conv_kernel_size - 1
    for repeat, ksizes in zip(cfg.repeat_in_block, cfg.mixconv_kernel_sizes):
        dropped += repeat * (max(ksizes) - 1) * cfg.stride
    return dropped


def tail_length(cfg: MixedNetConfig) -> int:
    """Time frames left at the tail for input length spectrogram_length."""
    t = cfg.spectrogram_length
    if cfg.first_conv_filters > 0:
        t = (t - cfg.first_conv_kernel_size) // cfg.stride + 1
    for repeat, ksizes in zip(cfg.repeat_in_block, cfg.mixconv_kernel_sizes):
        for _ in range(repeat):
            if max(ksizes) > 1:
                t -= max(ksizes) - 1
    return t


def stream_phase(cfg: MixedNetConfig) -> int:
    """Frames r by which ``forward`` must look past a streamed step.

    The non-streaming first conv (kernel k >= stride s) over T input frames
    leaves (T - k) % s trailing frames unused, while the streamed step that
    ends at frame e uses frame e - 1.  So that step's probability equals
    ``forward`` over frames [e - T + r, e + r); for the flagship (T 204, k 5,
    s 3) r is 1.
    """
    if cfg.first_conv_filters == 0:
        return 0
    return (cfg.spectrogram_length - cfg.first_conv_kernel_size) % cfg.stride


class Dense(L.PointwiseConv):
    """flax ``nn.Dense`` with a bias: weight [out, in], bias [out]."""

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, use_bias=True)


class SpatialAttention(nn.Module):
    """CBAM-style spatial attention over the tail window (mixednet.py:80-99).

    As in the JAX model, streaming gates only the newest frames, so streaming
    differs from non-streaming when it is on; it is off by default.
    """

    def __init__(self, channels: int, window: int, frames_per_step: int, kernel_size: int = 4):
        super().__init__()
        self.kernel_size = kernel_size
        self.StreamConv_0 = L.StreamConv(2, 1, kernel_size)
        self.StreamBuffer_0 = L.StreamBuffer(channels, window, frames_per_step)

    def run(self, x: torch.Tensor, prefix: str, cache, new_cache) -> torch.Tensor:
        pooled = torch.stack([x.mean(dim=-1), x.amax(dim=-1)], dim=-1)  # [B, T, 2]
        att = torch.sigmoid(
            L.stream_apply(self.StreamConv_0, f"{prefix}/StreamConv_0", pooled, cache, new_cache)
        )
        net = L.stream_apply(self.StreamBuffer_0, f"{prefix}/StreamBuffer_0", x, cache, new_cache)
        return net[:, -att.shape[1] :] * att


class MixedNet(L.StreamingModel):
    def __init__(self, cfg: MixedNetConfig, input_features: int = 40):
        super().__init__()
        self.cfg = cfg
        counts = collections.Counter()

        def add(kind: str, module: nn.Module) -> str:
            name = f"{kind}_{counts[kind]}"
            counts[kind] += 1
            self.add_module(name, module)
            return name

        # Frames that reach each streaming layer per step of ``stride`` slices.
        frames_per_step = cfg.stride
        c = input_features
        self.first_conv = None
        if cfg.first_conv_filters > 0:
            self.first_conv = add(
                "StreamConv",
                L.StreamConv(c, cfg.first_conv_filters, cfg.first_conv_kernel_size,
                             stride=cfg.stride),
            )
            c = cfg.first_conv_filters
            frames_per_step = 1

        # blocks: (residual (pointwise, bn) names or None, [(mixconv or None, pointwise, bn)])
        self.blocks = []
        for filters, repeat, ksizes, res in zip(
            cfg.pointwise_filters, cfg.repeat_in_block,
            cfg.mixconv_kernel_sizes, cfg.residual_connection,
        ):
            residual = None
            if res:
                residual = (add("PointwiseConv", L.PointwiseConv(c, filters)),
                            add("BatchNorm", L.BatchNorm(filters)))
            units = []
            for _ in range(repeat):
                mix = None
                if max(ksizes) > 1:
                    mix = add("MixConv", L.MixConv(c, tuple(ksizes), use_bias=cfg.mixconv_bias))
                units.append((mix, add("PointwiseConv", L.PointwiseConv(c, filters)),
                              add("BatchNorm", L.BatchNorm(filters))))
                c = filters
            self.blocks.append((residual, units))

        t_tail = tail_length(cfg)
        self.tail = None
        frames = t_tail
        if t_tail > 1:
            if cfg.spatial_attention:
                self.tail = add("SpatialAttention", SpatialAttention(c, t_tail, frames_per_step))
                frames = t_tail - self.get_submodule(self.tail).kernel_size + 1
            else:
                self.tail = add("StreamBuffer", L.StreamBuffer(c, t_tail, frames_per_step))
            if cfg.pooled:
                frames = 1
        self.dense = add("Dense", Dense(c * frames, 1))

    def _run(self, x: torch.Tensor, cache, new_cache) -> torch.Tensor:
        cfg = self.cfg
        if self.first_conv is not None:
            x = torch.relu(L.stream_apply(self.get_submodule(self.first_conv), self.first_conv,
                                  x, cache, new_cache))
        for residual, units in self.blocks:
            if residual is not None:
                pw, bn = (self.get_submodule(n) for n in residual)
                r = bn(pw(x))
            for mix, pw, bn in units:
                if mix is not None:
                    x = L.stream_apply(self.get_submodule(mix), mix, x, cache, new_cache)
                x = self.get_submodule(bn)(self.get_submodule(pw)(x))
                if residual is not None:
                    r = L.align_time(r, x)
                    x = x + r
                x = torch.relu(x)
        if self.tail is not None:
            tail = self.get_submodule(self.tail)
            if cfg.spatial_attention:
                x = tail.run(x, self.tail, cache, new_cache)
            else:
                x = L.stream_apply(tail, self.tail, x, cache, new_cache)
            if cfg.pooled:
                x = x.amax(dim=1, keepdim=True) if cfg.max_pool else x.mean(dim=1, keepdim=True)
        x = x.reshape(x.shape[0], -1)  # [B, T, C] flattens time-major
        return torch.sigmoid(self.get_submodule(self.dense)(x))

    def forward(self, x: torch.Tensor, dropout=None) -> torch.Tensor:
        """[B, T, 40] spectrogram -> [B, 1] wake probability.  MixedNet has no
        dropout layer: ``dropout`` (see ``Inception.forward``) is unused."""
        return self._run(x, None, None)
