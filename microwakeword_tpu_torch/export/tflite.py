"""Streaming TFLite export, the reference's deployment artifact (port of
``microwakeword_tpu/export/tflite.py``).

A trained model's state dict is laid into a hand-built TF streaming graph
whose ring buffers are ``tf.Variable``s, with only TFLM-supported ops
(CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED, CONCAT, STRIDED_SLICE, MUL/ADD,
LOGISTIC, VAR_HANDLE/READ/ASSIGN), the op set of the reference's exports for
ESPHome on the ESP32.  BatchNorm and SubSpectralNorm are folded into the
preceding conv in float32, in the JAX exporter's order, so that both write
the same bytes from the same weights.

Quantization follows the reference (utils.py:289-348): full int8 (int8
inputs, uint8 outputs), quantized ring-buffer variables, and a
representative dataset of training spectrograms chopped into (stride, 40)
steps with pixels pinned to the frontend range 0.0 / 26.0.

TFLite is a host program: the converter and the interpreter run on the CPU.
``tensorflow`` is imported inside the functions that need it.
"""

from __future__ import annotations

import os

import numpy as np

from microwakeword_tpu_torch.export.native_runtime import (
    conv_kernel,
    dense_kernel,
    mixconv_masked_kernel,
    numpy_state,
    unit_conv,
)
from microwakeword_tpu_torch.models import inception, mixednet
from microwakeword_tpu_torch.models.layers import BN_EPSILON, conv_ring_size


def _tensorflow():
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("the TFLite export needs tensorflow, which is not installed") from e
    return tf


def _bn_fold(state: dict, module: str) -> tuple[np.ndarray, np.ndarray]:
    """BatchNorm ``module`` -> (scale, offset) with BN(x) = x * scale +
    offset, in float32 as the JAX exporter folds it (the ``.mww`` exporter
    folds in float64)."""
    gamma, beta, mean, var = (np.asarray(state[f"{module}.{k}"], np.float32)
                              for k in ("scale", "bias", "mean", "var"))
    s = gamma / np.sqrt(var + BN_EPSILON)
    return s, beta - s * mean


def _ssn_fold(state: dict, unit: str, channels: int) -> tuple[np.ndarray, np.ndarray]:
    """A ConvBnRelu's SubSpectralNorm -> per-channel (scale, offset): channel
    c takes BatchNorm index c % g, so the g-vector is tiled."""
    s, b = _bn_fold(state, f"{unit}.SubSpectralNorm_0.BatchNorm_0")
    reps = channels // s.shape[0]
    return np.tile(s, reps), np.tile(b, reps)


def _ring(tf, net, v, size: int):
    """Prepends ring variable ``v`` to ``net`` on the time axis and stores
    the newest ``size`` frames back into it."""
    mem = tf.concat([v, net], axis=1)
    assign = v.assign(mem[:, -size:])
    with tf.control_dependencies([assign]):
        return tf.identity(mem)


def _ring_vars(tf, mod, specs) -> None:
    """One zero tf.Variable [1, frames, 1, channels] per (frames, channels)."""
    mod.ring_vars = [
        tf.Variable(tf.zeros([1, frames, 1, channels], tf.float32), trainable=False,
                    name=f"ring_{i}")
        for i, (frames, channels) in enumerate(specs)
    ]


def _finish(tf, mod, forward, t_in: int):
    mod.forward = tf.function(
        lambda x: forward(tf.reshape(x, [1, t_in, 1, 40])),
        input_signature=[tf.TensorSpec([1, t_in, 40], tf.float32, name="input")],
    )
    mod.forward.get_concrete_function()  # trace once to create the variables
    return mod


def build_tf_streaming_mixednet(cfg: mixednet.MixedNetConfig, state: dict,
                                streaming: bool = True):
    """A tf.Module running the MixedNet in streaming mode (input [1, stride,
    40], ring buffers as internal tf.Variables) or non-streaming mode (input
    [1, spectrogram_length, 40])."""
    tf = _tensorflow()
    state = numpy_state(state)
    mod = tf.Module()
    mod.ring_vars = []
    mix_idx, pw_idx, bn_idx = 0, 0, 0

    # ---- per-layer constants in model order ----------------------------
    layers = []
    if cfg.first_conv_filters > 0:
        layers.append(("first_conv", conv_kernel(state, "StreamConv_0")))  # [k, in, out]

    for repeat, ksizes, res in zip(cfg.repeat_in_block, cfg.mixconv_kernel_sizes,
                                   cfg.residual_connection):
        block = {"repeats": [], "residual": None}
        if res:
            w = dense_kernel(state, f"PointwiseConv_{pw_idx}")
            pw_idx += 1
            s, b = _bn_fold(state, f"BatchNorm_{bn_idx}")
            bn_idx += 1
            block["residual"] = (w * s[None, :], b)
        for _ in range(repeat):
            entry = {}
            if max(ksizes) > 1:
                dw = mixconv_masked_kernel(state, f"MixConv_{mix_idx}", ksizes)
                mix_idx += 1
                entry["mixconv"] = dw[:, None, :]  # [kmax, 1, C]
            w = dense_kernel(state, f"PointwiseConv_{pw_idx}")
            pw_idx += 1
            s, b = _bn_fold(state, f"BatchNorm_{bn_idx}")
            bn_idx += 1
            entry["pointwise"] = (w * s[None, :], b)
            block["repeats"].append(entry)
        layers.append(("block", block))

    dense_w = dense_kernel(state, "Dense_0")
    dense_b = np.asarray(state["Dense_0.bias"], np.float32)
    t_tail = mixednet.tail_length(cfg)

    att_kernel = None
    if cfg.spatial_attention and t_tail > 1:
        if streaming and not cfg.pooled:
            # streaming attention gates only the newest frame, so a
            # non-pooled flatten would not match the trained Dense's shape
            raise ValueError("spatial_attention requires pooled=True for streaming")
        att_kernel = conv_kernel(state, "SpatialAttention_0.StreamConv_0")  # [k, 2, 1]

    # ---- ring-buffer variables (static sizes, consumption order) -------
    if streaming:
        specs = []
        ch = 40
        for kind, payload in layers:
            if kind == "first_conv":
                ring = conv_ring_size(payload.shape[0], cfg.stride)
                if ring > 0:
                    specs.append((ring, payload.shape[1]))
                ch = payload.shape[-1]
            else:
                for entry in payload["repeats"]:
                    if "mixconv" in entry and entry["mixconv"].shape[0] > 1:
                        specs.append((entry["mixconv"].shape[0] - 1, entry["mixconv"].shape[2]))
                    ch = entry["pointwise"][0].shape[-1]
        if att_kernel is not None and att_kernel.shape[0] > 1:
            # attention replaces the tail window: a ring of (mean, max)
            # pooled frames; only the newest (gated) frame feeds Dense
            specs.append((att_kernel.shape[0] - 1, 2))
        elif t_tail > 1:
            specs.append((t_tail - 1, ch))  # the blocks emit one frame per step
        _ring_vars(tf, mod, specs)

    def forward(x):  # x: [1, T, 1, 40]
        net = x
        rings = iter(mod.ring_vars)
        for kind, payload in layers:
            if kind == "first_conv":
                kernel = payload
                ring = conv_ring_size(kernel.shape[0], cfg.stride)
                if streaming and ring > 0:
                    net = _ring(tf, net, next(rings), ring)
                net = tf.nn.conv2d(net, kernel[:, None, :, :], strides=[1, cfg.stride, 1, 1],
                                   padding="VALID")
                net = tf.nn.relu(net)
                continue
            block = payload
            if block["residual"] is not None:
                w, b = block["residual"]
                residual = tf.nn.conv2d(net, w[None, None, :, :], strides=1, padding="VALID") + b
            for entry in block["repeats"]:
                if "mixconv" in entry:
                    dw = entry["mixconv"]  # [kmax, 1, C]
                    kmax = dw.shape[0]
                    if streaming and kmax > 1:
                        net = _ring(tf, net, next(rings), kmax - 1)
                    net = tf.nn.depthwise_conv2d(net, dw[:, :, :, None], strides=[1, 1, 1, 1],
                                                 padding="VALID")
                w, b = entry["pointwise"]
                net = tf.nn.conv2d(net, w[None, None, :, :], strides=1, padding="VALID") + b
                if block["residual"] is not None:
                    drop = residual.shape[1] - net.shape[1]
                    residual = residual[:, drop:] if drop > 0 else residual
                    net = net + residual
                net = tf.nn.relu(net)

        if t_tail > 1 and att_kernel is not None:
            # CBAM spatial attention: sigmoid(conv_k over per-frame (mean,
            # max) channel pools) gates the trailing frames (streaming: the
            # newest one)
            pooled = tf.stack([tf.reduce_mean(net, axis=-1), tf.reduce_max(net, axis=-1)],
                              axis=-1)  # [1, T, 1, 2]
            if streaming and att_kernel.shape[0] > 1:
                pooled = _ring(tf, pooled, next(rings), att_kernel.shape[0] - 1)
            att = tf.sigmoid(tf.nn.conv2d(pooled, att_kernel[:, None, :, :], strides=1,
                                          padding="VALID"))
            net = net[:, -att.shape[1]:] * att
            if cfg.pooled:  # over the gated window (streaming: one frame)
                if cfg.max_pool:
                    net = tf.reduce_max(net, axis=1, keepdims=True)
                else:
                    net = tf.reduce_mean(net, axis=1, keepdims=True)
        elif t_tail > 1:
            if streaming:
                net = _ring(tf, net, next(rings), t_tail - net.shape[1])
            if cfg.pooled:
                pool = tf.nn.max_pool2d if cfg.max_pool else tf.nn.avg_pool2d
                net = pool(net, [t_tail, 1], [t_tail, 1], "VALID")
        net = tf.reshape(net, [1, -1])
        return tf.sigmoid(tf.matmul(net, dense_w) + dense_b)

    return _finish(tf, mod, forward, cfg.stride if streaming else cfg.spectrogram_length)


def build_tf_streaming_inception(cfg: inception.InceptionConfig, state: dict,
                                 streaming: bool = True):
    """A tf.Module running the Inception model in streaming mode (input [1, 1,
    40], a ring buffer per conv as tf.Variables) or non-streaming mode (input
    [1, spectrogram_length, 40]): valid (dilated) time convs with
    SubSpectralNorm folded in, branch outputs aligned by dropping leading
    frames (the reference's StridedDrop, strided_drop.py:40-44), the tail
    window ring, then Dense + sigmoid."""
    tf = _tensorflow()
    state = numpy_state(state)
    mod = tf.Module()
    mod.ring_vars = []
    idx = 0

    def conv_bn(dilation: int):
        """ConvBnRelu_{idx}: (kernel [k, in, out] with the norm's scale
        folded in, offset, dilation)."""
        nonlocal idx
        unit = f"ConvBnRelu_{idx}"
        idx += 1
        pointwise, kernel = unit_conv(state, unit)
        if pointwise:
            kernel = kernel[None, :, :]
        scale, offset = _ssn_fold(state, unit, kernel.shape[-1])
        return kernel * scale[None, None, :], offset, dilation

    cnn1 = [conv_bn(1) for _ in cfg.cnn1_filters]
    # creation order: b1 (1x1), b2 (1x1, k), b3 (1x1, k, k), the 1x1 after the concat
    blocks = [[conv_bn(dil) for _ in range(7)] for dil in cfg.cnn2_dilation]
    dense_w = dense_kernel(state, "Dense_0")
    dense_b = np.asarray(state["Dense_0.bias"], np.float32)
    t_tail = inception.tail_length(cfg)

    if streaming:
        specs = []
        for kernel, _, dil in cnn1 + [e for entries in blocks for e in entries[:6]]:
            ring = dil * (kernel.shape[0] - 1)
            if ring > 0:
                specs.append((ring, kernel.shape[1]))
        if t_tail > 1:
            ch = blocks[-1][6][0].shape[-1] if blocks else cnn1[-1][0].shape[-1]
            specs.append((t_tail - 1, ch))
        _ring_vars(tf, mod, specs)

    def apply_conv(net, kernel, offset, dil, rings):
        ring = dil * (kernel.shape[0] - 1)
        if streaming and ring > 0:
            net = _ring(tf, net, next(rings), ring)
        net = tf.nn.conv2d(net, kernel[:, None, :, :], strides=[1, 1, 1, 1],
                           dilations=[1, dil, 1, 1], padding="VALID") + offset
        return tf.nn.relu(net)

    def forward(x):  # x: [1, T, 1, 40]
        net = x
        rings = iter(mod.ring_vars)
        for unit in cnn1:
            net = apply_conv(net, *unit, rings)
        for entries in blocks:
            b1 = apply_conv(net, *entries[0], rings)
            b2 = apply_conv(apply_conv(net, *entries[1], rings), *entries[2], rings)
            b3 = apply_conv(net, *entries[3], rings)
            b3 = apply_conv(apply_conv(b3, *entries[4], rings), *entries[5], rings)
            # align leading frames (StridedDrop; the identity when streaming)
            d1, d2 = b1.shape[1] - b3.shape[1], b2.shape[1] - b3.shape[1]
            b1 = b1[:, d1:] if d1 > 0 else b1
            b2 = b2[:, d2:] if d2 > 0 else b2
            net = apply_conv(tf.concat([b1, b2, b3], axis=-1), *entries[6], rings)
        if streaming and t_tail > 1:
            net = _ring(tf, net, next(rings), t_tail - 1)
        net = tf.reshape(net, [1, -1])
        return tf.sigmoid(tf.matmul(net, dense_w) + dense_b)

    return _finish(tf, mod, forward, cfg.stride if streaming else cfg.spectrogram_length)


def build_tf_streaming(name: str, cfg, state: dict, streaming: bool = True):
    """The streaming (or non-streaming) TF graph of either model family."""
    if name == "mixednet":
        return build_tf_streaming_mixednet(cfg, state, streaming)
    if name == "inception":
        return build_tf_streaming_inception(cfg, state, streaming)
    raise ValueError(f"no TFLite exporter for model {name!r}")


def representative_dataset(feature_handler, config, n_specs: int = 500, streaming: bool = True):
    """The reference's calibration generator (utils.py:303-325): training
    spectrograms chopped into (stride, 40) steps, with the frontend range
    pinned to 0.0 at [0, 0] and 26.0 at [-1, -1] of each chunk.

    ``streaming=False`` yields whole windows instead: (stride, 40) chunks
    cannot calibrate a non-streaming graph, so the JAX package departs from
    the reference there, and so does the port."""
    stride = config.get("stride", 1)
    x, _, _ = feature_handler.get_data("training", batch_size=n_specs,
                                       features_length=config["spectrogram_length"],
                                       truncation_strategy="default")

    def chunks(spec):
        if not streaming:
            yield np.array(spec, np.float32)
            return
        for i in range(0, (spec.shape[0] // stride) * stride, stride):
            yield np.array(spec[i : i + stride], np.float32)

    def gen():
        for spec in x:
            for chunk in chunks(spec):
                chunk[0, 0] = 0.0
                chunk[-1, -1] = 26.0
                yield [chunk[None, ...]]

    return gen


def convert_to_tflite(module, output_path: str, quantize: bool = False,
                      representative_gen=None) -> str:
    """Converts the tf.Module (with its ring-buffer variables) to a
    ``.tflite`` file at ``output_path``; returns the path."""
    tf = _tensorflow()
    cf = module.forward.get_concrete_function()
    converter = tf.lite.TFLiteConverter.from_concrete_functions([cf], module)
    converter._experimental_variable_quantization = quantize
    if quantize:
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
        converter.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
        converter.inference_input_type = tf.int8
        converter.inference_output_type = tf.uint8
        if representative_gen is not None:
            converter.representative_dataset = representative_gen
    blob = converter.convert()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "wb") as f:
        f.write(blob)
    return output_path


class TFLiteStreamingModel:
    """An exported TFLite model in the interpreter (the reference's
    inference.py:34-125).  Streaming models consume (stride, 40) slices;
    non-streaming ones consume whole (spectrogram_length, 40) windows slid by
    stride, the window length read from the model's input shape as the
    reference's ``input_feature_slices`` is.

    ``reset`` starts a new interpreter on the same file: the interpreter's
    ``reset_all_variables``, which the JAX package calls, leaves the ring
    buffers (resource variables) as they are, so that each track would
    start from the previous track's state.
    """

    def __init__(self, path: str, stride: int = 1):
        self.path = path
        self.stride = stride
        self.reset()
        self.input_details = self.interp.get_input_details()
        self.output_details = self.interp.get_output_details()
        self.window = int(self.input_details[0]["shape"][1])

    def reset(self) -> None:
        self.interp = _tensorflow().lite.Interpreter(model_path=self.path)
        self.interp.allocate_tensors()
        for d in self.interp.get_input_details():
            self.interp.set_tensor(d["index"], np.zeros(d["shape"], d["dtype"]))

    def _quantize_input(self, x):
        d = self.input_details[0]
        if d["dtype"] in (np.int8, np.uint8):
            scale, zp = d["quantization"]
            return np.clip(np.round(x / scale + zp), -128, 127).astype(d["dtype"])
        return x.astype(np.float32)

    def _dequantize_output(self, y):
        d = self.output_details[0]
        if d["dtype"] in (np.int8, np.uint8):
            _, zp = d["quantization"]
            # the reference fixes the output scale at 1/255 (inference.py:162-170)
            return (y.astype(np.float32) - zp) / 255.0
        return y

    def predict_spectrogram(self, spectrogram: np.ndarray) -> np.ndarray:
        """[T, 40] float features (or uint16 codes) -> the probability of
        each window of ``self.window`` slices ending at a stride multiple
        (the reference's inference.py:98-106); a streaming model's window is
        its stride, one probability per new slice."""
        if np.issubdtype(spectrogram.dtype, np.uint16):
            spectrogram = spectrogram.astype(np.float32) * 0.0390625
        probs = []
        d_in = self.input_details[0]
        for last in range(self.window, spectrogram.shape[0] + 1, self.stride):
            chunk = np.asarray(spectrogram[last - self.window : last], np.float32)[None, ...]
            self.interp.set_tensor(d_in["index"], self._quantize_input(chunk))
            self.interp.invoke()
            out = self.interp.get_tensor(self.output_details[0]["index"])
            probs.append(float(self._dequantize_output(out).reshape(-1)[0]))
        return np.asarray(probs, np.float32)


def tflite_model_accuracy(tflite_path: str, feature_handler, config: dict,
                          data_set: str = "testing", folder: str | None = None,
                          accuracy_name: str = "tflite_model_accuracy.txt") -> dict:
    """Accuracy of an exported TFLite model on a test set (the reference's
    tflite_model_accuracy, test.py:406-517).

    Non-ambient sets (truncate_start): the prediction is the last window's
    probability > 0.5.  Ambient sets ('none'): 0.5-crossing false accepts
    with a refractory window of spectrogram_length_final_layer slices, and
    false accepts per hour.
    """
    runner = TFLiteStreamingModel(tflite_path, stride=config.get("stride", 1))
    truncation = "none" if data_set.endswith("ambient") else "truncate_start"
    x, y, _ = feature_handler.get_data(data_set, batch_size=config.get("batch_size", 128),
                                       features_length=config["spectrogram_length"],
                                       truncation_strategy=truncation)
    tp = tn = fp = fn = 0
    for spec, label in zip(x, np.atleast_1d(y)):
        runner.reset()
        probs = runner.predict_spectrogram(np.asarray(spec))
        if truncation != "none":
            pred = bool(len(probs)) and probs[-1] > 0.5
            if label > 0.5:
                tp, fn = tp + pred, fn + (not pred)
            else:
                fp, tn = fp + pred, tn + (not pred)
        else:
            refractory = int(config.get("spectrogram_length_final_layer", 0))
            previous, last_accept = 0.0, 0
            for i, p in enumerate(probs):
                if previous <= 0.5 < p and (i - last_accept > refractory):
                    fp += 1
                    last_accept = i
                previous = float(p)
    count = tp + tn + fp + fn
    metrics = {
        "accuracy": (tp + tn) / count if count else float("nan"),
        "recall": tp / (tp + fn) if (tp + fn) else float("nan"),
        "precision": tp / (tp + fp) if (tp + fp) else float("nan"),
        "false_positive_rate": fp / (fp + tn) if (fp + tn) else float("nan"),
        "false_negative_rate": fn / (tp + fn) if (tp + fn) else float("nan"),
        "count": count,
        "false_positives": fp,
    }
    if data_set.endswith("ambient"):
        hours = feature_handler.get_mode_duration(data_set) / 3600.0
        metrics["false_accepts_per_hour"] = fp / hours if hours else float("nan")
    if folder:
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, accuracy_name), "w") as f:
            if data_set.endswith("ambient"):
                f.write(f"false accepts = {fp}; false accepts per hour = "
                        f"{metrics['false_accepts_per_hour']:.4}")
            else:
                f.write(repr(metrics))
    return metrics


def export_and_evaluate_tflite(bundle, model, feature_handler, config, train_dir: str,
                               quantize: bool, streaming: bool = True) -> str:
    """The CLI's TFLite step: exports the trained ``model`` (a module) to
    ``train_dir/tflite_<name>/<name>.tflite`` (streaming or not, optionally
    int8), scores the streamed ROC through the interpreter, and the
    test-set accuracy and ambient false accepts (the reference's
    model_train_eval.py:131-274 and test.py:406-517).  The streaming int8
    file also gets the ESPHome manifest, its cutoff read off the measured
    ROC at ``target_faph`` (default 0.5).  Returns the ``.tflite`` path."""
    from microwakeword_tpu_torch.evaluate.streaming_eval import streaming_model_roc

    name = ("stream_state_internal" if streaming else "non_stream") + ("_quant" if quantize else "")
    folder = os.path.join(train_dir, f"tflite_{name}")
    module = build_tf_streaming(bundle.name, bundle.config, model.state_dict(), streaming=streaming)
    rep = representative_dataset(feature_handler, config, streaming=streaming) if quantize else None
    path = convert_to_tflite(module, os.path.join(folder, f"{name}.tflite"), quantize, rep)

    runner = TFLiteStreamingModel(path, stride=config.get("stride", 1))

    def stream_fn(_model, x):
        runner.reset()
        return runner.predict_spectrogram(np.asarray(x)[0])

    if feature_handler.get_mode_size("testing_ambient"):
        result = streaming_model_roc(bundle, model, feature_handler, config, folder=folder,
                                     accuracy_name="tflite_streaming_roc.txt", stream_fn=stream_fn)
        print(f"TFLite ({name}) streaming ROC AUC: {result['auc']:.5f}")
        if streaming and quantize:
            from microwakeword_tpu_torch.export.manifest import recommended_cutoff, write_manifest

            wake_word = config.get("wake_word", os.path.basename(os.path.normpath(train_dir)))
            manifest_path = write_manifest(
                path, wake_word=str(wake_word),
                probability_cutoff=recommended_cutoff(
                    result, target_faph=float(config.get("target_faph", 0.5))),
                sliding_window_size=5, feature_step_size=int(config.get("window_step_ms", 10)))
            print(f"ESPHome manifest: {manifest_path}")
    if feature_handler.get_mode_size("testing"):
        m = tflite_model_accuracy(path, feature_handler, config, data_set="testing", folder=folder)
        print(f"TFLite ({name}) testing accuracy: {m['accuracy']:.4%}")
    if feature_handler.get_mode_size("testing_ambient"):
        tflite_model_accuracy(path, feature_handler, config, data_set="testing_ambient",
                              folder=folder, accuracy_name="tflite_ambient_false_accepts.txt")
    return path
