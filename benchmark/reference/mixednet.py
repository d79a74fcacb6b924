"""The plain reference of MixedNet (microWakeWord ``mixednet.py``): a
strided valid first conv and relu, then per block a MixConv (depthwise
convs of several kernel sizes over groups of channels, the first group
taking the remainder, each group's output aligned to the newest frames), a
1x1 conv, BatchNorm, an optional 1x1-conv residual and relu; the tail's
frames flattened time-major, a dense layer and a sigmoid.

``forward`` is the full-window pass (training, or eval with the running
statistics), ``stream_probs`` the streamed model as its ring buffers define
it: every layer over the whole stream with its ring of zeros in front, one
probability per ``stride`` input frames.  Weights are a state dict under the
model's parameter names (the port's checkpoint names).  Spatial attention
and pooling are not written: ``check`` refuses them.
"""

from __future__ import annotations

import torch

from benchmark.reference import layers as L


def check(cfg: dict) -> None:
    for key in ("spatial_attention", "pooled", "max_pool"):
        if cfg.get(key):
            raise NotImplementedError(f"the MixedNet reference has no {key}")
    if cfg["first_conv_filters"] <= 0:
        raise NotImplementedError("the MixedNet reference needs the first conv")


def stride(cfg: dict) -> int:
    return int(cfg["stride"])


def _blocks(cfg: dict):
    """[(residual (pointwise, batchnorm) or None, [(mixconv or None,
    pointwise, batchnorm, channels in, filters, kernel sizes)])], named as
    the model names its submodules (a counter per kind, in build order)."""
    counts = {"StreamConv": 0}

    def name(kind):
        counts[kind] = counts.get(kind, -1) + 1
        return f"{kind}_{counts[kind]}"

    c, blocks = cfg["first_conv_filters"], []
    for filters, repeat, ksizes, residual in zip(cfg["pointwise_filters"], cfg["repeat_in_block"],
                                                 cfg["mixconv_kernel_sizes"],
                                                 cfg["residual_connection"]):
        res = (name("PointwiseConv"), name("BatchNorm")) if residual else None
        units = []
        for _ in range(repeat):
            mix = name("MixConv") if max(ksizes) > 1 else None
            units.append((mix, name("PointwiseConv"), name("BatchNorm"), c, filters, tuple(ksizes)))
            c = filters
        blocks.append((res, units))
    return blocks


def split_channels(total: int, groups: int) -> list[int]:
    split = [total // groups] * groups
    split[0] += total - sum(split)
    return split


def tail_length(cfg: dict) -> int:
    t = (cfg["spectrogram_length"] - cfg["first_conv_kernel_size"]) // cfg["stride"] + 1
    for repeat, ksizes in zip(cfg["repeat_in_block"], cfg["mixconv_kernel_sizes"]):
        t -= repeat * (max(ksizes) - 1)
    return t


def state_shapes(cfg: dict, features: int = 40) -> dict:
    """name -> shape of every entry of the model's state dict, in its order."""
    check(cfg)
    shapes = {}
    c = cfg["first_conv_filters"]
    shapes["StreamConv_0.weight"] = (c, features, cfg["first_conv_kernel_size"])
    for res, units in _blocks(cfg):
        if res is not None:
            shapes[f"{res[0]}.weight"] = (units[0][4], units[0][3])
            for k in ("scale", "bias", "mean", "var"):
                shapes[f"{res[1]}.{k}"] = (units[0][4],)
        for mix, pw, bn, c_in, filters, ksizes in units:
            if mix is not None:
                shapes[f"{mix}.weight"] = (c_in, 1, max(ksizes))
            shapes[f"{pw}.weight"] = (filters, c_in)
            for k in ("scale", "bias", "mean", "var"):
                shapes[f"{bn}.{k}"] = (filters,)
    c = cfg["pointwise_filters"][-1]
    shapes["Dense_0.weight"] = (1, c * tail_length(cfg))
    shapes["Dense_0.bias"] = (1,)
    return shapes


def _mixconv(x, weight, ksizes, pad: bool):
    """Each channel group's depthwise conv with its own kernel size (its
    newest taps of the stored [C, 1, kmax] kernel), aligned to the newest
    frames; ``pad`` puts the ring's kmax - 1 zero frames in front."""
    kmax = max(ksizes)
    if pad:
        x = L.left_pad(x, kmax - 1)
    outs, start = [], 0
    for width, k in zip(split_channels(x.shape[2], len(ksizes)), ksizes):
        y = L.conv(x[:, :, start:start + width], weight[start:start + width, :, kmax - k:],
                   groups=width)
        outs.append(y[:, kmax - k:])
        start += width
    return torch.cat(outs, dim=2)


def _bn(state, name, x, train):
    return L.batch_norm(x, state[f"{name}.scale"], state[f"{name}.bias"], state[f"{name}.mean"],
                        state[f"{name}.var"], train)


def _body(state, cfg, x, train: bool, stream: bool):
    k, s = cfg["first_conv_kernel_size"], cfg["stride"]
    if stream:
        x = L.left_pad(x, max(0, k - s))
    x = torch.relu(L.conv(x, state["StreamConv_0.weight"], stride=s))
    for res, units in _blocks(cfg):
        r = None if res is None else _bn(state, res[1], x @ state[f"{res[0]}.weight"].T, train)
        for mix, pw, bn, _, _, ksizes in units:
            if mix is not None:
                x = _mixconv(x, state[f"{mix}.weight"], ksizes, stream)
            x = _bn(state, bn, x @ state[f"{pw}.weight"].T, train)
            if r is not None:
                r = r[:, r.shape[1] - x.shape[1]:]
                x = x + r
            x = torch.relu(x)
    return x


def _dense(state, x):
    return torch.sigmoid(x @ state["Dense_0.weight"].T + state["Dense_0.bias"])


def forward(state: dict, cfg: dict, x: torch.Tensor, train: bool = False,
            keep=None) -> torch.Tensor:
    """[B, T, 40] -> [B, 1] probabilities, in the state's dtype; ``keep`` is
    unused (MixedNet has no dropout)."""
    check(cfg)
    h = _body(state, cfg, x.to(state["Dense_0.weight"].dtype), train, stream=False)
    return _dense(state, h.reshape(h.shape[0], -1))


def stream_probs(state: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """[B, T, 40] -> [B, T // stride] streamed probabilities from zero rings."""
    check(cfg)
    s = cfg["stride"]
    x = x[:, : x.shape[1] // s * s].to(state["Dense_0.weight"].dtype)
    h = _body(state, cfg, x, train=False, stream=True)
    return _dense(state, L.tail_windows(h, tail_length(cfg)))[..., 0]
