"""The plain reference of microWakeWord's Inception (``inception.py``):
valid first convs, each with SubSpectralNorm (BatchNorm over the channel
sub-groups c % g) and relu; per block three branches from the block's input
(a 1x1 conv; a 1x1 then a dilated k conv; a 1x1 then two dilated k convs),
each unit a conv, SubSpectralNorm and relu, cut to the shortest branch's
newest frames and concatenated, then a 1x1 unit; the tail's frames flattened
time-major, dropout, a dense layer and a sigmoid.

``forward`` is the full-window pass (in training with the batch's
statistics and a given dropout keep mask), ``stream_probs`` the streamed
model: every k conv over the whole stream with its ring of (k - 1) * d zero
frames in front, one probability per frame.  Weights are a state dict under
the model's parameter names.
"""

from __future__ import annotations

import torch

from benchmark.reference import layers as L


def stride(cfg: dict) -> int:
    return 1


def _units(cfg: dict):
    """(first units, blocks); a unit is (name, c_in, c_out, k, dilation,
    sub-groups), a block (b1, b2, b3, post), named ConvBnRelu_<i> in build
    order."""
    index = iter(range(10_000))

    def unit(c_in, c_out, k=1, d=1, g=1):
        return (f"ConvBnRelu_{next(index)}", c_in, c_out, k, d, g)

    c, first = 40, []
    for filters, k, g in zip(cfg["cnn1_filters"], cfg["cnn1_kernel_sizes"],
                             cfg["cnn1_subspectral_groups"]):
        first.append(unit(c, filters, k, 1, g))
        c = filters
    blocks = []
    for f1, f2, k, g, d in zip(cfg["cnn2_filters1"], cfg["cnn2_filters2"], cfg["cnn2_kernel_sizes"],
                               cfg["cnn2_subspectral_groups"], cfg["cnn2_dilation"]):
        b1 = [unit(c, f1, g=g)]
        b2 = [unit(c, f1, g=g), unit(f1, f1, k, d, g)]
        b3 = [unit(c, f1, g=g), unit(f1, f1, k, d, g), unit(f1, f1, k, d, g)]
        blocks.append((b1, b2, b3, unit(3 * f1, f2)))
        c = f2
    return first, blocks


def tail_length(cfg: dict) -> int:
    dropped = sum(k - 1 for k in cfg["cnn1_kernel_sizes"])
    dropped += sum(2 * d * (k - 1) for k, d in zip(cfg["cnn2_kernel_sizes"], cfg["cnn2_dilation"]))
    return cfg["spectrogram_length"] - dropped


def state_shapes(cfg: dict, features: int = 40) -> dict:
    first, blocks = _units(cfg)
    shapes, order = {}, list(first)
    for b1, b2, b3, post in blocks:
        order += b1 + b2 + b3 + [post]
    for name, c_in, c_out, k, d, g in order:
        conv = "PointwiseConv_0" if k == 1 else "StreamConv_0"
        shapes[f"{name}.{conv}.weight"] = (c_out, c_in) if k == 1 else (c_out, c_in, k)
        for key in ("scale", "bias", "mean", "var"):
            shapes[f"{name}.SubSpectralNorm_0.BatchNorm_0.{key}"] = (c_out if g == 1 else g,)
    c = cfg["cnn2_filters2"][-1] if cfg["cnn2_filters2"] else cfg["cnn1_filters"][-1]
    shapes["Dense_0.weight"] = (1, c * tail_length(cfg))
    shapes["Dense_0.bias"] = (1,)
    return shapes


def _unit(state, unit, x, train: bool, stream: bool):
    name, _, _, k, d, g = unit
    if k == 1:
        x = x @ state[f"{name}.PointwiseConv_0.weight"].T
    else:
        if stream:
            x = L.left_pad(x, (k - 1) * d)
        x = L.conv(x, state[f"{name}.StreamConv_0.weight"], dilation=d)
    bn = f"{name}.SubSpectralNorm_0.BatchNorm_0"
    b, t, c = x.shape
    y = L.batch_norm(x.reshape(b, t, c // g, g) if g > 1 else x, state[f"{bn}.scale"],
                     state[f"{bn}.bias"], state[f"{bn}.mean"], state[f"{bn}.var"], train)
    return torch.relu(y.reshape(b, t, c))


def _body(state, cfg, x, train: bool, stream: bool):
    first, blocks = _units(cfg)

    def branch(units, h):
        for u in units:
            h = _unit(state, u, h, train, stream)
        return h

    x = branch(first, x)
    for b1, b2, b3, post in blocks:
        ys = [branch(b1, x), branch(b2, x), branch(b3, x)]
        t = min(y.shape[1] for y in ys)
        x = _unit(state, post, torch.cat([y[:, y.shape[1] - t:] for y in ys], dim=2), train, stream)
    return x


def _dense(state, x):
    return torch.sigmoid(x @ state["Dense_0.weight"].T + state["Dense_0.bias"])


def dropout_width(cfg: dict) -> int:
    """Width of the flattened tail that the dropout masks."""
    return state_shapes(cfg)["Dense_0.weight"][1]


def forward(state: dict, cfg: dict, x: torch.Tensor, train: bool = False,
            keep=None) -> torch.Tensor:
    """[B, T, 40] -> [B, 1] probabilities in the state's dtype.  In training
    ``keep`` is the dropout's boolean keep mask [B, tail * C]: kept values
    are divided by the keep probability, the others are 0."""
    h = _body(state, cfg, x.to(state["Dense_0.weight"].dtype), train, stream=False)
    h = h.reshape(h.shape[0], -1)
    if train and cfg.get("dropout", 0) > 0:
        h = torch.where(keep, h / (1.0 - cfg["dropout"]), torch.zeros_like(h))
    return _dense(state, h)


def stream_probs(state: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """[B, T, 40] -> [B, T] streamed probabilities from zero rings."""
    h = _body(state, cfg, x.to(state["Dense_0.weight"].dtype), train=False, stream=True)
    return _dense(state, L.tail_windows(h, tail_length(cfg)))[..., 0]
