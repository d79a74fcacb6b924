"""Exporter to the C++ streaming runtime's format (``.mww``), float weights
(port of ``microwakeword_tpu/export/native_runtime.py``).

Compiles a trained model's state dict into the flat op list and float32
weight blob that ``native/src/mww_runtime.cc`` executes one streaming step at
a time with explicit ring buffers.  NumPy only.  The state dict holds the
port's PyTorch layouts; each weight is written in the runtime's layout (the
flax one), and BatchNorm is folded into a per-channel affine in float64 as
the JAX exporter does, so both write the same bytes from the same weights.

Binary layout (little-endian; the header's version field is 2):
    u32 magic 'MWW1' (0x3157574D)   u32 version
    i32 stride        i32 n_input_features
    i32 n_ops         i32 n_tensors
    n_ops x op record: 10 x i32  [type, p0..p8]
    n_tensors x (u64 float_offset, u64 n_floats)
    blob: float32[]

Op types (native/src/mww_runtime.cc must match):
    0 CONV      p: k, stride, in_ch, out_ch, w, bias(-1), dilation(0=1)
                                               ring dilation*(k-1)-(stride-1)
    1 RELU      p: ch
    2 MIXCONV   p: kmax, ch, w                              ring kmax-1
    3 POINTWISE p: in_ch, out_ch, w, bias(-1)
    4 BNORM     p: ch, scale, offset                        (folded)
    5 RES_SAVE  p: ch, slot                      (also generic branch save)
    6 RES_APPLY p: in_ch, out_ch, w, scale, offset, slot
    7 TAIL      p: window, ch, pooled, max_pool             ring window-1
    8 DENSE_SIG p: in_dim, out_dim, w, bias
    9 RESTORE   p: ch, slot
   10 CONCAT    p: ch1, slot1, ch2, slot2, ch3   cur = [s1, s2, cur]
   11 SPATTN    p: ch, k, w([k,2])               ring (k-1) x (mean,max)
"""

from __future__ import annotations

import struct

import numpy as np

from microwakeword_tpu_torch.models import inception, mixednet
from microwakeword_tpu_torch.models.layers import BN_EPSILON, MixConv

MAGIC = 0x3157574D
OP_CONV, OP_RELU, OP_MIXCONV, OP_POINTWISE, OP_BNORM = 0, 1, 2, 3, 4
OP_RES_SAVE, OP_RES_APPLY, OP_TAIL, OP_DENSE_SIG = 5, 6, 7, 8
OP_RESTORE, OP_CONCAT, OP_SPATTN = 9, 10, 11


class _Builder:
    def __init__(self):
        self.ops: list[list[int]] = []
        self.tensors: list[np.ndarray] = []

    def tensor(self, arr: np.ndarray) -> int:
        self.tensors.append(np.ascontiguousarray(arr, dtype=np.float32))
        return len(self.tensors) - 1

    def op(self, op_type: int, *params: int) -> None:
        rec = [op_type, *params]
        rec += [0] * (10 - len(rec))
        self.ops.append(rec)

    def serialize(self, stride: int, n_features: int) -> bytes:
        out = [struct.pack("<IIiiii", MAGIC, 2, stride, n_features, len(self.ops),
                           len(self.tensors))]
        for rec in self.ops:
            out.append(struct.pack("<10i", *rec))
        offset = 0
        for t in self.tensors:
            out.append(struct.pack("<QQ", offset, t.size))
            offset += t.size
        for t in self.tensors:
            out.append(t.tobytes())
        return b"".join(out)


# ---- the port's state dict in the runtime's layouts ------------------------


def numpy_state(state: dict) -> dict:
    """A state dict of tensors (on any device) or arrays -> numpy arrays."""
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in state.items()}


def conv_kernel(state: dict, module: str) -> np.ndarray:
    """StreamConv weight [out, in, k] -> [k, in, out]."""
    return state[f"{module}.weight"].transpose(2, 1, 0)


def dense_kernel(state: dict, module: str) -> np.ndarray:
    """PointwiseConv / Dense weight [out, in] -> [in, out]."""
    return state[f"{module}.weight"].T


def fold_bn(state: dict, module: str) -> tuple[np.ndarray, np.ndarray]:
    """BatchNorm ``module``'s scale, bias, mean, var -> float32 (scale,
    offset) with y = x * scale + offset, computed in float64."""
    gamma, beta, mean, var = (np.asarray(state[f"{module}.{k}"], np.float64)
                              for k in ("scale", "bias", "mean", "var"))
    scale = gamma / np.sqrt(var + BN_EPSILON)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


def mixconv_masked_kernel(state: dict, module: str, kernel_sizes) -> np.ndarray:
    """MixConv weight [C, 1, kmax] -> [kmax, C] with the group mask applied
    (group g keeps its newest k_g taps)."""
    kernel = state[f"{module}.weight"].transpose(2, 1, 0)  # [kmax, 1, C]
    kmax, ch = kernel.shape[0], kernel.shape[-1]
    mask = np.zeros((kmax, ch), np.float32)
    start = 0
    for width, k in zip(MixConv.split_channels(ch, len(kernel_sizes)), kernel_sizes):
        mask[kmax - k :, start : start + width] = 1.0
        start += width
    return kernel[:, 0, :] * mask


def ssn_fold(state: dict, unit: str, channels: int) -> tuple[np.ndarray, np.ndarray]:
    """A ConvBnRelu's SubSpectralNorm -> per-channel (scale, offset); channel
    c takes BatchNorm index c % g."""
    scale, offset = fold_bn(state, f"{unit}.SubSpectralNorm_0.BatchNorm_0")
    reps = channels // scale.shape[0]
    return np.tile(scale, reps), np.tile(offset, reps)


def unit_conv(state: dict, unit: str) -> tuple[bool, np.ndarray]:
    """A ConvBnRelu's conv: (is 1x1, kernel in the runtime's layout)."""
    if f"{unit}.PointwiseConv_0.weight" in state:
        return True, dense_kernel(state, f"{unit}.PointwiseConv_0")
    return False, conv_kernel(state, f"{unit}.StreamConv_0")


# ---- exporters ---------------------------------------------------------------


def export_mixednet(bundle, state: dict, path: str) -> None:
    """Serializes a MixedNet bundle and its state dict to ``path`` (.mww)."""
    cfg: mixednet.MixedNetConfig = bundle.config
    if cfg.spatial_attention and not cfg.pooled:
        # Without pooling the streaming Dense input (C) cannot match the
        # non-streaming trained Dense ((tail-3)*C): no streaming form.
        raise ValueError("spatial_attention requires pooled=True for streaming")
    state = numpy_state(state)
    b = _Builder()
    pw_i = bn_i = mix_i = 0

    ch = bundle.input_features
    if cfg.first_conv_filters > 0:
        w = b.tensor(conv_kernel(state, "StreamConv_0"))
        b.op(OP_CONV, cfg.first_conv_kernel_size, cfg.stride, ch, cfg.first_conv_filters, w, -1)
        ch = cfg.first_conv_filters
        b.op(OP_RELU, ch)

    slot = 0
    for filters, repeat, ksizes, res in zip(cfg.pointwise_filters, cfg.repeat_in_block,
                                            cfg.mixconv_kernel_sizes, cfg.residual_connection):
        res_parts = None
        if res:
            rw = b.tensor(dense_kernel(state, f"PointwiseConv_{pw_i}"))
            pw_i += 1
            scale, offset = fold_bn(state, f"BatchNorm_{bn_i}")
            bn_i += 1
            res_parts = (ch, filters, rw, b.tensor(scale), b.tensor(offset), slot)
            b.op(OP_RES_SAVE, ch, slot)
            slot += 1
        for _ in range(repeat):
            if max(ksizes) > 1:
                w = b.tensor(mixconv_masked_kernel(state, f"MixConv_{mix_i}", ksizes))
                mix_i += 1
                b.op(OP_MIXCONV, max(ksizes), ch, w)
            w = b.tensor(dense_kernel(state, f"PointwiseConv_{pw_i}"))
            pw_i += 1
            scale, offset = fold_bn(state, f"BatchNorm_{bn_i}")
            bn_i += 1
            b.op(OP_POINTWISE, ch, filters, w, -1)
            ch = filters
            b.op(OP_BNORM, ch, b.tensor(scale), b.tensor(offset))
            if res_parts is not None:
                b.op(OP_RES_APPLY, *res_parts)
            b.op(OP_RELU, ch)

    t_tail = mixednet.tail_length(cfg)
    dense_in = ch
    if t_tail > 1:
        if cfg.spatial_attention:
            # the streaming SpatialAttention gates only the newest frame, and
            # pooling over one frame is the identity: the dense input is [ch]
            att = conv_kernel(state, "SpatialAttention_0.StreamConv_0")  # [k, 2, 1]
            b.op(OP_SPATTN, ch, att.shape[0], b.tensor(att[:, :, 0]))
        else:
            b.op(OP_TAIL, t_tail, ch, int(cfg.pooled), int(cfg.max_pool))
            dense_in = ch if cfg.pooled else t_tail * ch
    w = b.tensor(dense_kernel(state, "Dense_0"))  # [in, 1]
    b.op(OP_DENSE_SIG, dense_in, 1, w, b.tensor(state["Dense_0.bias"]))

    with open(path, "wb") as f:
        f.write(b.serialize(cfg.stride, bundle.input_features))


def export_inception(bundle, state: dict, path: str) -> None:
    """Serializes an Inception bundle and its state dict to ``path`` (.mww):
    (dilated) valid convs with SubSpectralNorm folded to a per-channel
    affine, each block's three branches computed from a saved input
    (RES_SAVE / RESTORE) and concatenated, the tail window, Dense+sigmoid."""
    cfg: inception.InceptionConfig = bundle.config
    state = numpy_state(state)
    b = _Builder()
    idx = 0

    def emit_unit(in_ch: int, dilation: int = 1) -> int:
        """ConvBnRelu_{idx}: conv, folded SubSpectralNorm, relu; returns its
        output channels."""
        nonlocal idx
        unit = f"ConvBnRelu_{idx}"
        pointwise, kernel = unit_conv(state, unit)
        out_ch = kernel.shape[-1]
        if pointwise:
            b.op(OP_POINTWISE, in_ch, out_ch, b.tensor(kernel), -1)
        else:
            b.op(OP_CONV, kernel.shape[0], 1, in_ch, out_ch, b.tensor(kernel), -1, dilation)
        scale, offset = ssn_fold(state, unit, out_ch)
        b.op(OP_BNORM, out_ch, b.tensor(scale), b.tensor(offset))
        b.op(OP_RELU, out_ch)
        idx += 1
        return out_ch

    ch = bundle.input_features
    for _ in cfg.cnn1_filters:
        ch = emit_unit(ch)

    slot_in, slot_b1, slot_b2 = 0, 1, 2
    for dil in cfg.cnn2_dilation:
        b.op(OP_RES_SAVE, ch, slot_in)
        f1 = emit_unit(ch)  # b1: 1x1
        b.op(OP_RES_SAVE, f1, slot_b1)
        b.op(OP_RESTORE, ch, slot_in)
        c2 = emit_unit(emit_unit(ch), dil)  # b2: 1x1, k
        b.op(OP_RES_SAVE, c2, slot_b2)
        b.op(OP_RESTORE, ch, slot_in)
        c3 = emit_unit(emit_unit(emit_unit(ch), dil), dil)  # b3: 1x1, k, k
        b.op(OP_CONCAT, f1, slot_b1, c2, slot_b2, c3)
        ch = emit_unit(f1 + c2 + c3)  # the 1x1 after the concat
    t_tail = inception.tail_length(cfg)
    dense_in = ch
    if t_tail > 1:
        b.op(OP_TAIL, t_tail, ch, 0, 0)
        dense_in = t_tail * ch
    w = b.tensor(dense_kernel(state, "Dense_0"))
    b.op(OP_DENSE_SIG, dense_in, 1, w, b.tensor(state["Dense_0.bias"]))

    with open(path, "wb") as f:
        f.write(b.serialize(cfg.stride, bundle.input_features))


def export_model(bundle, state: dict, path: str, quantize: bool = False,
                 calibration=None) -> None:
    """Exports a MixedNet or Inception state dict to the ``.mww`` format.

    ``quantize=True`` writes the full-int8 v3 format
    (``export/native_quant.py``), with activation ranges calibrated on
    ``calibration``, [N, T, 40] spectrograms."""
    if quantize:
        from microwakeword_tpu_torch.export.native_quant import export_int8

        export_int8(bundle, state, path, calibration=calibration)
    elif bundle.name == "mixednet":
        export_mixednet(bundle, state, path)
    elif bundle.name == "inception":
        export_inception(bundle, state, path)
    else:
        raise ValueError(f"no native exporter for model {bundle.name!r}")
