"""Full-int8 export for the C++ streaming runtime (``.mww`` v3; port of
``microwakeword_tpu/export/native_quant.py``).

BatchNorm (and SubSpectralNorm) is folded into the convs; per-tensor
activation ranges are calibrated by running representative spectrograms
through a float64 NumPy simulator of the folded op graph, which is first held
against the live model; the file holds int8 weights (per-output-channel
symmetric scales), int8 activations and ring buffers (asymmetric per-tensor
scale and zero point), int32 biases and float requantization multipliers.
The input is pinned to the frontend's [0, 26] feature range.  The three
branch outputs of each Inception block share one scale, so the streaming
concat is an int8 copy.  NumPy does the work from the port's state dict, as
the JAX exporter does from flax variables, so both write the same bytes.

v3 binary layout (little-endian; native/src/mww_runtime.cc must match):
    u32 magic 'MWW1'   u32 version=3
    i32 stride         i32 n_input_features
    i32 n_ops          i32 n_tensors
    n_ops x op record: 10 x i32  [type, p0..p8]
    n_tensors x (u64 byte_offset, u64 n_elems, u32 dtype, u32 pad)
        dtype: 0 = float32, 1 = int8, 2 = int32
    blob: raw bytes (each tensor 4-byte aligned)

Quantized op types:
    20 QIN    p: n, qt              quantize incoming float frames
    21 QCONV  p: k, stride, in_ch, out_ch, w, bias(-1), dil, relu, qt
              qt = f32 [zp_in, zp_out, M_0..M_{out-1}]   ring: int8
    22 QMIX   p: kmax, ch, w, qt    qt = f32 [zp_in, zp_out, M_0..M_{ch-1}]
    23 QPW    p: in_ch, out_ch, w, bias, relu, qt       (BN folded)
    24 QSAVE  p: ch, slot           int8 copy of the block input
    25 QRES   p: in_ch, out_ch, w, bias, slot, qt
              qt = f32 [zp_sv, zp_mid, zp_out, A, B_0..B_{out-1}]
    26 QTAIL  p: window, ch, pooled, max_pool, qt([zp]) ring: int8
    27 QDENSE p: in_dim, w, qt      qt = f32 [zp_in, s_in*s_w, bias]
    28 QRESTORE p: ch, slot         cur8 = slot
    29 QCONCAT  p: c1, slot1, c2, slot2, c3   (shared scale by export)
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from microwakeword_tpu_torch.export import native_runtime as NR
from microwakeword_tpu_torch.models import inception, mixednet

OP_QIN, OP_QCONV, OP_QMIX, OP_QPW = 20, 21, 22, 23
OP_QSAVE, OP_QRES, OP_QTAIL, OP_QDENSE = 24, 25, 26, 27
OP_QRESTORE, OP_QCONCAT = 28, 29

DT_F32, DT_I8, DT_I32 = 0, 1, 2

# The folded simulator against the live model, max |d| of the probabilities.
SELF_CHECK_TOL = 5e-3


# ---- the folded float stage graph and its float64 simulator -----------------


def _f64(a) -> np.ndarray:
    return np.asarray(a, np.float64)


def build_stages_mixednet(bundle, state: dict) -> list[dict]:
    """MixedNet as a list of folded float stages (BatchNorm into the 1x1s)."""
    cfg: mixednet.MixedNetConfig = bundle.config
    if cfg.spatial_attention:
        raise ValueError("int8 native export does not support spatial_attention")
    if cfg.mixconv_bias:
        raise ValueError("int8 native export does not support mixconv_bias")
    stages = []
    pw_i = bn_i = mix_i = 0
    ch = bundle.input_features
    if cfg.first_conv_filters > 0:
        stages.append(dict(kind="conv", k=cfg.first_conv_kernel_size, stride=cfg.stride,
                           in_ch=ch, out_ch=cfg.first_conv_filters,
                           w=_f64(NR.conv_kernel(state, "StreamConv_0")), relu=True))
        ch = cfg.first_conv_filters

    slot = 0
    for filters, repeat, ksizes, res in zip(cfg.pointwise_filters, cfg.repeat_in_block,
                                            cfg.mixconv_kernel_sizes, cfg.residual_connection):
        res_parts = None
        if res:
            rw = _f64(NR.dense_kernel(state, f"PointwiseConv_{pw_i}"))
            pw_i += 1
            scale, offset = NR.fold_bn(state, f"BatchNorm_{bn_i}")
            bn_i += 1
            res_parts = dict(w=rw * _f64(scale)[None, :], b=_f64(offset), slot=slot)
            stages.append(dict(kind="save", ch=ch, slot=slot))
            slot += 1
        for _ in range(repeat):
            if max(ksizes) > 1:
                wm = NR.mixconv_masked_kernel(state, f"MixConv_{mix_i}", ksizes)
                mix_i += 1
                stages.append(dict(kind="mix", kmax=max(ksizes), ch=ch, w=_f64(wm)))
            w = _f64(NR.dense_kernel(state, f"PointwiseConv_{pw_i}"))
            pw_i += 1
            scale, offset = NR.fold_bn(state, f"BatchNorm_{bn_i}")
            bn_i += 1
            stages.append(dict(kind="pw", in_ch=ch, out_ch=filters, w=w * _f64(scale)[None, :],
                               b=_f64(offset), relu=res_parts is None))
            ch = filters
            if res_parts is not None:
                stages.append(dict(kind="res", in_ch=res_parts["w"].shape[0], out_ch=ch,
                                   w=res_parts["w"], b=res_parts["b"], slot=res_parts["slot"]))

    t_tail = mixednet.tail_length(cfg)
    dense_in = ch
    if t_tail > 1:
        stages.append(dict(kind="tail", window=t_tail, ch=ch, pooled=bool(cfg.pooled),
                           max_pool=bool(cfg.max_pool)))
        dense_in = ch if cfg.pooled else t_tail * ch
    stages.append(dict(kind="dense", in_dim=dense_in, w=_f64(NR.dense_kernel(state, "Dense_0")),
                       b=_f64(state["Dense_0.bias"])))
    return stages


def build_stages_inception(bundle, state: dict) -> list[dict]:
    """Inception as folded float stages: SubSpectralNorm into the convs; the
    three branch-final stages of each block share a scale group, so the
    concat is a pure int8 copy."""
    cfg: inception.InceptionConfig = bundle.config
    stages = []
    idx = 0

    def unit(in_ch: int, dilation: int = 1, group=None) -> int:
        """ConvBnRelu_{idx} with its SubSpectralNorm folded; returns out channels."""
        nonlocal idx
        name = f"ConvBnRelu_{idx}"
        pointwise, kernel = NR.unit_conv(state, name)
        w = _f64(kernel)
        out_ch = w.shape[-1]
        scale, offset = NR.ssn_fold(state, name, out_ch)
        if pointwise:
            stages.append(dict(kind="pw", in_ch=in_ch, out_ch=out_ch, w=w * _f64(scale)[None, :],
                               b=_f64(offset), relu=True, group=group))
        else:
            stages.append(dict(kind="conv", k=w.shape[0], stride=1, in_ch=in_ch, out_ch=out_ch,
                               dilation=dilation, w=w * _f64(scale)[None, None, :],
                               b=_f64(offset), relu=True, group=group))
        idx += 1
        return out_ch

    ch = bundle.input_features
    for _ in cfg.cnn1_filters:
        ch = unit(ch)

    slot_in, slot_b1, slot_b2 = 0, 1, 2
    for gi, dil in enumerate(cfg.cnn2_dilation):
        group = f"concat_{gi}"
        stages.append(dict(kind="save", ch=ch, slot=slot_in))
        f1 = unit(ch, group=group)  # b1: 1x1
        stages.append(dict(kind="save", ch=f1, slot=slot_b1))
        stages.append(dict(kind="restore", ch=ch, slot=slot_in))
        c2 = unit(unit(ch), dil, group=group)  # b2: 1x1, k
        stages.append(dict(kind="save", ch=c2, slot=slot_b2))
        stages.append(dict(kind="restore", ch=ch, slot=slot_in))
        c3 = unit(unit(unit(ch), dil), dil, group=group)  # b3: 1x1, k, k
        stages.append(dict(kind="concat", ch1=f1, slot1=slot_b1, ch2=c2, slot2=slot_b2, ch3=c3,
                           group=group))
        ch = unit(f1 + c2 + c3)  # the 1x1 after the concat
    t_tail = inception.tail_length(cfg)
    dense_in = ch
    if t_tail > 1:
        stages.append(dict(kind="tail", window=t_tail, ch=ch, pooled=False, max_pool=False))
        dense_in = t_tail * ch
    stages.append(dict(kind="dense", in_dim=dense_in, w=_f64(NR.dense_kernel(state, "Dense_0")),
                       b=_f64(state["Dense_0.bias"])))
    return stages


def simulate(stages: list[dict], x: np.ndarray):
    """Runs the folded float graph over [B, T, F] in float64; returns (the
    last step's probabilities [B], [(min, max) of each stage's output])."""
    ranges = []
    saved = {}
    for st in stages:
        kind = st["kind"]
        if kind == "conv":
            k, s, d = st["k"], st["stride"], st.get("dilation", 1)
            t_out = (x.shape[1] - d * (k - 1) - 1) // s + 1
            out = np.zeros((x.shape[0], t_out, st["out_ch"]))
            for j in range(k):
                out += np.einsum("bti,io->bto", x[:, j * d : j * d + (t_out - 1) * s + 1 : s],
                                 st["w"][j])
            if "b" in st:
                out += st["b"][None, None, :]
            x = np.maximum(out, 0.0) if st["relu"] else out
        elif kind == "save":
            saved[st["slot"]] = x
        elif kind == "restore":
            x = saved[st["slot"]]
        elif kind == "concat":
            t = x.shape[1]
            x = np.concatenate([saved[st["slot1"]][:, -t:], saved[st["slot2"]][:, -t:], x],
                               axis=-1)
        elif kind == "mix":
            kmax = st["kmax"]
            t_out = x.shape[1] - kmax + 1
            out = np.zeros((x.shape[0], t_out, st["ch"]))
            for j in range(kmax):
                out += x[:, j : j + t_out] * st["w"][j][None, None, :]
            x = out
        elif kind == "pw":
            x = np.einsum("bti,io->bto", x, st["w"]) + st["b"][None, None, :]
            if st["relu"]:
                x = np.maximum(x, 0.0)
        elif kind == "res":
            branch = np.einsum("bti,io->bto", saved[st["slot"]], st["w"]) + st["b"][None, None, :]
            x = np.maximum(x + branch[:, -x.shape[1] :], 0.0)
        elif kind == "tail":
            x = x[:, -st["window"] :]
            if st["pooled"]:
                x = (x.max(axis=1, keepdims=True) if st["max_pool"]
                     else x.mean(axis=1, keepdims=True))
            x = x.reshape(x.shape[0], 1, -1)
        elif kind == "dense":
            logits = np.einsum("bti,io->bto", x, st["w"]) + st["b"]
            x = 1.0 / (1.0 + np.exp(-logits))
        ranges.append((float(x.min()), float(x.max())))
    return x[:, -1, 0], ranges


# ---- quantization --------------------------------------------------------------


def _act_q(lo: float, hi: float) -> tuple[float, int]:
    """Asymmetric int8 (scale, zero point) covering [lo, hi]."""
    lo, hi = min(lo, 0.0), max(hi, 1e-6)
    scale = (hi - lo) / 255.0
    zp = int(np.clip(round(-128 - lo / scale), -128, 127))
    return float(scale), zp


def _w_q(w: np.ndarray, axis):
    """Per-output-channel symmetric int8 weights, reducing over ``axis``."""
    mx = np.maximum(np.abs(w).max(axis=axis, keepdims=True), 1e-12)
    s = mx / 127.0
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return q, np.squeeze(s, axis=axis)


def _bias_q(b: np.ndarray, scale: np.ndarray) -> np.ndarray:
    q = np.round(b / scale).astype(np.int64)
    return np.clip(q, -(2**31) + 1, 2**31 - 1).astype(np.int32)


class _QBuilder:
    def __init__(self):
        self.ops = []
        self.tensors = []  # (bytes, n_elems, dtype)

    def tensor(self, arr, dtype: int) -> int:
        arr = np.ascontiguousarray(
            arr, dtype={DT_F32: np.float32, DT_I8: np.int8, DT_I32: np.int32}[dtype])
        self.tensors.append((arr.tobytes(), arr.size, dtype))
        return len(self.tensors) - 1

    def op(self, op_type: int, *params: int) -> None:
        rec = [op_type, *params]
        rec += [0] * (10 - len(rec))
        self.ops.append(rec)

    def serialize(self, stride: int, n_features: int) -> bytes:
        out = [struct.pack("<IIiiii", NR.MAGIC, 3, stride, n_features, len(self.ops),
                           len(self.tensors))]
        for rec in self.ops:
            out.append(struct.pack("<10i", *rec))
        blob = bytearray()
        table = []
        for data, n, dt in self.tensors:
            while len(blob) % 4:
                blob += b"\0"
            table.append((len(blob), n, dt))
            blob += data
        for off, n, dt in table:
            out.append(struct.pack("<QQII", off, n, dt, 0))
        out.append(bytes(blob))
        return b"".join(out)


def self_check(bundle, state: dict, stages: list[dict], x: np.ndarray) -> float:
    """max |d| between the folded simulator and the live model on ``x``.

    The live forward runs in float32 on a CPU copy of the module: the
    simulator is host float64, and an accelerator's own rounding (TF32
    among it) is no fault of the fold."""
    probs, _ = simulate(stages, x)
    model = bundle.load(state, device="cpu")
    with torch.inference_mode():
        live = bundle.forward(model, torch.from_numpy(x.astype(np.float32))).reshape(-1).numpy()
    return float(np.abs(probs - live).max())


def export_int8(bundle, state: dict, path: str, calibration=None) -> None:
    """Exports a MixedNet or Inception state dict as a full-int8 ``.mww`` (v3).

    ``calibration``: [N, spectrogram_length, 40] float spectrograms in the
    [0, 26] feature convention; uniform noise over that range by default (the
    CLI passes training windows).  Raises ValueError for what has no int8
    form (spatial attention, a MixConv bias) and when the folded simulator
    deviates from the live model by more than SELF_CHECK_TOL, so that the
    CLI's guard skips the artifact instead of aborting the run.
    """
    cfg = bundle.config
    state = NR.numpy_state(state)
    if bundle.name == "mixednet":
        stages = build_stages_mixednet(bundle, state)
    elif bundle.name == "inception":
        stages = build_stages_inception(bundle, state)
    else:
        raise ValueError(f"no int8 native exporter for model {bundle.name!r}")

    if calibration is None:
        calibration = np.random.default_rng(0).uniform(
            0.0, 26.0, (64, cfg.spectrogram_length, bundle.input_features))
    calib = np.asarray(calibration, np.float64)
    err = self_check(bundle, state, stages, calib[:8])
    if err > SELF_CHECK_TOL:
        raise ValueError(f"folded float simulator deviates from the live model ({err:.2e})")
    _, ranges = simulate(stages, calib)

    # the branches of a concat share one scale: the union of their ranges
    groups = {}
    for i, st in enumerate(stages):
        if st.get("group") is not None:
            groups.setdefault(st["group"], []).append(i)
    for idxs in groups.values():
        lo = min(ranges[i][0] for i in idxs)
        hi = max(ranges[i][1] for i in idxs)
        for i in idxs:
            ranges[i] = (lo, hi)

    b = _QBuilder()
    s_cur, zp_cur = _act_q(0.0, 26.0)  # the input, pinned to the frontend's range
    b.op(OP_QIN, cfg.stride * bundle.input_features, b.tensor([s_cur, zp_cur], DT_F32))
    save_scales = {}
    for st, (lo, hi) in zip(stages, ranges):
        kind = st["kind"]
        if kind == "conv":
            s_out, zp_out = _act_q(lo, hi)
            wq, sw = _w_q(st["w"], axis=(0, 1))  # [k, in, out] -> per out
            bias_ref = b.tensor(_bias_q(st["b"], s_cur * sw), DT_I32) if "b" in st else -1
            qt = b.tensor(np.concatenate([[zp_cur, zp_out], s_cur * sw / s_out]), DT_F32)
            b.op(OP_QCONV, st["k"], st["stride"], st["in_ch"], st["out_ch"],
                 b.tensor(wq, DT_I8), bias_ref, st.get("dilation", 1), int(st["relu"]), qt)
            s_cur, zp_cur = s_out, zp_out
        elif kind == "save":
            save_scales[st["slot"]] = (s_cur, zp_cur)
            b.op(OP_QSAVE, st["ch"], st["slot"])
        elif kind == "restore":
            b.op(OP_QRESTORE, st["ch"], st["slot"])
            s_cur, zp_cur = save_scales[st["slot"]]
        elif kind == "concat":
            b.op(OP_QCONCAT, st["ch1"], st["slot1"], st["ch2"], st["slot2"], st["ch3"])
        elif kind == "mix":
            s_out, zp_out = _act_q(lo, hi)
            wq, sw = _w_q(st["w"], axis=(0,))  # [kmax, ch] -> per ch
            qt = b.tensor(np.concatenate([[zp_cur, zp_out], s_cur * sw / s_out]), DT_F32)
            b.op(OP_QMIX, st["kmax"], st["ch"], b.tensor(wq, DT_I8), qt)
            s_cur, zp_cur = s_out, zp_out
        elif kind == "pw":
            s_out, zp_out = _act_q(lo, hi)
            wq, sw = _w_q(st["w"], axis=(0,))  # [in, out] -> per out
            bias_q = _bias_q(st["b"], s_cur * sw)
            qt = b.tensor(np.concatenate([[zp_cur, zp_out], s_cur * sw / s_out]), DT_F32)
            b.op(OP_QPW, st["in_ch"], st["out_ch"], b.tensor(wq, DT_I8),
                 b.tensor(bias_q, DT_I32), int(st["relu"]), qt)
            s_cur, zp_cur = s_out, zp_out
        elif kind == "res":
            s_out, zp_out = _act_q(lo, hi)
            s_sv, zp_sv = save_scales[st["slot"]]
            wq, sw = _w_q(st["w"], axis=(0,))
            bias_q = _bias_q(st["b"], s_sv * sw)
            qt = b.tensor(np.concatenate([[zp_sv, zp_cur, zp_out, s_cur / s_out],
                                          s_sv * sw / s_out]), DT_F32)
            b.op(OP_QRES, st["in_ch"], st["out_ch"], b.tensor(wq, DT_I8),
                 b.tensor(bias_q, DT_I32), st["slot"], qt)
            s_cur, zp_cur = s_out, zp_out
        elif kind == "tail":  # mean, max and flatten keep the scale
            qt = b.tensor([zp_cur], DT_F32)
            b.op(OP_QTAIL, st["window"], st["ch"], int(st["pooled"]), int(st["max_pool"]), qt)
        elif kind == "dense":
            wq, sw = _w_q(st["w"], axis=(0, 1))  # per tensor (out_dim 1)
            qt = b.tensor([zp_cur, s_cur * float(sw.reshape(-1)[0]),
                           float(st["b"].reshape(-1)[0])], DT_F32)
            b.op(OP_QDENSE, st["in_dim"], b.tensor(wq, DT_I8), qt)

    with open(path, "wb") as f:
        f.write(b.serialize(cfg.stride, bundle.input_features))
