"""Model FLOPs of MixedNet from the configuration's shapes: 2 per
multiply-add of each convolution and dense layer (BatchNorm, relu and the
sigmoid are not counted), over the frames that the output needs.  A
MixConv group of kernel size k counts k taps, whatever the stored kernel's
width."""

from __future__ import annotations

from benchmark.reference.mixednet import _blocks, split_channels


def _layers(cfg: dict, features: int = 40):
    """(multiply-adds per output frame, frames per forward, frames per
    streamed step) of each layer."""
    t = (cfg["spectrogram_length"] - cfg["first_conv_kernel_size"]) // cfg["stride"] + 1
    out = [(cfg["first_conv_filters"] * features * cfg["first_conv_kernel_size"], t, 1)]
    for res, units in _blocks(cfg):
        for mix, _, _, c_in, filters, ksizes in units:
            if mix is not None:
                t -= max(ksizes) - 1
                taps = sum(w * k for w, k in zip(split_channels(c_in, len(ksizes)), ksizes))
                out.append((taps, t, 1))
            out.append((c_in * filters, t, 1))
        if res is not None:  # the residual 1x1 conv, over the frames the block keeps
            out.append((units[0][3] * units[0][4], t, 1))
    out.append((cfg["pointwise_filters"][-1] * t, 1, 1))  # the dense layer over the tail
    return out


def forward_flops(cfg: dict) -> float:
    """FLOPs of one full-window forward pass of one example."""
    return float(sum(2 * macs * frames for macs, frames, _ in _layers(cfg)))


def stream_step_flops(cfg: dict) -> float:
    """FLOPs of one streamed step of one stream (``stride`` new frames)."""
    return float(sum(2 * macs * step for macs, _, step in _layers(cfg)))
