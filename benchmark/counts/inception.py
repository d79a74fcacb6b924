"""Model FLOPs of Inception from the configuration's shapes: 2 per
multiply-add of each convolution and the dense layer (SubSpectralNorm, relu,
dropout and the sigmoid are not counted), over the frames that the output
needs: a branch cut to the shortest one is counted over the frames kept."""

from __future__ import annotations

from benchmark.reference.inception import _units, tail_length


def _needed(units, t_out: int):
    """(multiply-adds, frames) of each unit of a branch whose last unit
    must give ``t_out`` frames."""
    out = []
    for _, c_in, c_out, k, d, _ in reversed(units):
        out.append((c_in * c_out * k, t_out))
        t_out += (k - 1) * d
    return out


def forward_flops(cfg: dict) -> float:
    first, blocks = _units(cfg)
    t = cfg["spectrogram_length"]
    total = 0.0
    for _, c_in, c_out, k, d, _ in first:
        t -= (k - 1) * d
        total += 2 * c_in * c_out * k * t
    for b1, b2, b3, post in blocks:
        k, d = b3[1][3], b3[1][4]
        t -= 2 * (k - 1) * d
        for branch in (b1, b2, b3):
            total += sum(2 * macs * frames for macs, frames in _needed(branch, t))
        total += 2 * post[1] * post[2] * t
    c = blocks[-1][3][2] if blocks else first[-1][2]
    return total + 2 * c * t


def stream_step_flops(cfg: dict) -> float:
    first, blocks = _units(cfg)
    units = list(first) + [u for b in blocks for br in b[:3] for u in br] + [b[3] for b in blocks]
    c = blocks[-1][3][2] if blocks else first[-1][2]
    return float(sum(2 * c_in * c_out * k for _, c_in, c_out, k, _, _ in units)
                 + 2 * c * tail_length(cfg))
