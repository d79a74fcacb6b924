"""CLI entry point: train and evaluate wake-word models on the card (port of
model_train_eval.py).

    python -m microwakeword_tpu_torch.model_train_eval \\
        --training_config=training_parameters.yaml --train 1 \\
        mixednet --pointwise_filters "64,64,64,64" --stride 3 ...

The flags are the JAX CLI's, with the reference's per-model subparsers and
string-list flags, plus ``--device`` (default ``cuda``; ``--device cpu``
runs on the CPU).  ``main`` parses the flags and the YAML and writes
``training_config.yaml``; ``run`` does the rest and needs no PyYAML.  As in
the JAX CLI, ``--export_native`` (default 1) writes ``native/model.mww`` and
the full-int8 ``native/model_quant.mww`` for the C++ streaming runtime, and
``--test_native_quantized`` scores the int8 file's streamed ROC through it;
``--export_stablehlo`` (default 1; the JAX flag's name, so that JAX command
lines run unchanged) writes ``torch_export/model.mwwt``, the serialized
``torch.export`` programs (``export/torch_export.py``); the four
``--test_tflite_*`` flags export and score the ``.tflite`` files (streaming
or not, float or int8; the streaming int8 one with its ESPHome manifest),
which needs TensorFlow on the host.

``--mesh N`` trains and evaluates data parallel over N ranks
(``parallel/``): under ``torchrun`` the ranks are its processes (RANK,
WORLD_SIZE, LOCAL_RANK); otherwise ``run`` starts N workers itself
(``parallel.mesh.launch``, spawn).  Ranks on cards (one per card) talk over
NCCL; ``--device cpu --mesh N`` runs N gloo ranks on the CPU.  N may not
exceed the visible cards and must divide the batch; ``auto`` takes the
largest such count of two or more cards, else one device, and ``off`` one
device.  Rank 0 writes every file and returns the result.
"""

from __future__ import annotations

import argparse
import ast
import os

from microwakeword_tpu_torch.device import resolve_device

# --test_tflite_* flag -> (quantize, streaming) of its .tflite file, in the
# JAX CLI's order
TFLITE_RUNS = {
    "test_tflite_streaming": (False, True), "test_tflite_streaming_quantized": (True, True),
    "test_tflite_nonstreaming": (False, False), "test_tflite_nonstreaming_quantized": (True, False),
}


def parse(text):
    """Parses reference-style string flags: '128,128' or '[5], [7,11]'
    (reference mixednet.py:25-40)."""
    if not text:
        return []
    res = ast.literal_eval(str(text))
    if isinstance(res, tuple):
        return list(res)
    return [res]


def add_mixednet_flags(p):
    p.add_argument("--pointwise_filters", type=str, default="48, 48, 48, 48")
    p.add_argument("--residual_connection", type=str, default="0,0,0,0")
    p.add_argument("--repeat_in_block", type=str, default="1,1,1,1")
    p.add_argument("--mixconv_kernel_sizes", type=str, default="[5], [9], [13], [21]")
    p.add_argument("--max_pool", type=int, default=0)
    p.add_argument("--first_conv_filters", type=int, default=32)
    p.add_argument("--first_conv_kernel_size", type=int, default=3)
    p.add_argument("--spatial_attention", type=int, default=0)
    p.add_argument("--pooled", type=int, default=0)
    p.add_argument("--stride", type=int, default=1)


def add_inception_flags(p):
    p.add_argument("--cnn1_filters", type=str, default="24")
    p.add_argument("--cnn1_kernel_sizes", type=str, default="5")
    p.add_argument("--cnn1_subspectral_groups", type=str, default="4")
    p.add_argument("--cnn2_filters1", type=str, default="10,10,16")
    p.add_argument("--cnn2_filters2", type=str, default="10,10,16")
    p.add_argument("--cnn2_kernel_sizes", type=str, default="5,5,5")
    p.add_argument("--cnn2_subspectral_groups", type=str, default="1,1,1")
    p.add_argument("--cnn2_dilation", type=str, default="1,1,1")
    p.add_argument("--dropout", type=float, default=0.2)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--training_config", type=str, required=True)
    parser.add_argument("--train", type=int, default=1)
    parser.add_argument("--restore_checkpoint", type=int, default=0)
    parser.add_argument("--use_weights", type=str, default="best_weights")
    parser.add_argument("--test_streaming", type=int, default=1,
                        help="Streamed ambient ROC with the streaming model")
    parser.add_argument("--test_tf_nonstreaming", type=int, default=0,
                        help="Test-set accuracy of the non-streaming model")
    parser.add_argument("--export_native", type=int, default=1,
                        help="Export train_dir/native/model.mww and model_quant.mww for the "
                             "C++ streaming runtime (native/src/mww_runtime.cc)")
    parser.add_argument("--test_native_quantized", type=int, default=0,
                        help="Streamed ambient ROC of native/model_quant.mww through the C++ "
                             "runtime (requires --export_native)")
    for name in TFLITE_RUNS:
        parser.add_argument(f"--{name}", type=int, default=0,
                            help="Export and score this .tflite file (needs TensorFlow)")
    parser.add_argument("--export_stablehlo", type=int, default=1,
                        help="Export train_dir/torch_export/model.mwwt, the serialized "
                             "torch.export programs (export/torch_export.py)")
    parser.add_argument("--mesh", type=str, default="auto",
                        help="'auto' (every visible card that divides the batch, one device "
                             "below two), 'off' (one device), or a rank count N: data "
                             "parallel over N ranks (NCCL on cards, gloo with --device cpu)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to train and evaluate on: cuda (default) or cpu")
    sub = parser.add_subparsers(dest="model_name", required=True)
    add_mixednet_flags(sub.add_parser("mixednet"))
    add_inception_flags(sub.add_parser("inception"))
    return parser


def model_config_from_flags(flags):
    from microwakeword_tpu_torch.models import inception as I
    from microwakeword_tpu_torch.models import mixednet as MX

    if flags.model_name == "mixednet":
        ks = parse(flags.mixconv_kernel_sizes)
        ks = tuple(tuple(k) if isinstance(k, (list, tuple)) else (k,) for k in ks)
        return MX.MixedNetConfig(
            pointwise_filters=tuple(parse(flags.pointwise_filters)),
            repeat_in_block=tuple(parse(flags.repeat_in_block)),
            mixconv_kernel_sizes=ks,
            residual_connection=tuple(bool(r) for r in parse(flags.residual_connection)),
            first_conv_filters=flags.first_conv_filters,
            first_conv_kernel_size=flags.first_conv_kernel_size,
            stride=flags.stride,
            max_pool=bool(flags.max_pool),
            pooled=bool(flags.pooled),
            spatial_attention=bool(flags.spatial_attention),
            spectrogram_length=10_000,  # placeholder; derive_config replaces it
        )
    if flags.model_name == "inception":
        return I.InceptionConfig(
            cnn1_filters=tuple(parse(flags.cnn1_filters)),
            cnn1_kernel_sizes=tuple(parse(flags.cnn1_kernel_sizes)),
            cnn1_subspectral_groups=tuple(parse(flags.cnn1_subspectral_groups)),
            cnn2_filters1=tuple(parse(flags.cnn2_filters1)),
            cnn2_filters2=tuple(parse(flags.cnn2_filters2)),
            cnn2_kernel_sizes=tuple(parse(flags.cnn2_kernel_sizes)),
            cnn2_subspectral_groups=tuple(parse(flags.cnn2_subspectral_groups)),
            cnn2_dilation=tuple(parse(flags.cnn2_dilation)),
            dropout=flags.dropout,
            spectrogram_length=10_000,  # placeholder; derive_config replaces it
        )
    raise ValueError(f"unknown model {flags.model_name!r}")


def export_native(bundle, model, feature_handler, config: dict, native_dir: str) -> dict:
    """``native_dir``/model.mww, and model_quant.mww calibrated on 200
    training windows (the JAX CLI's representative set), as the JAX CLI
    writes them; returns {"float": path, "int8": path or None}.  An int8
    export that raises ValueError (no int8 form, or the exporter's
    self-check) is skipped with a message, as in the JAX CLI."""
    from microwakeword_tpu_torch.export.native_runtime import export_model

    os.makedirs(native_dir, exist_ok=True)
    out = {"float": os.path.join(native_dir, "model.mww"), "int8": None}
    state = model.state_dict()
    export_model(bundle, state, out["float"])
    print(f"native streaming model: {out['float']}")
    try:
        calib, _, _ = feature_handler.get_data(
            "training", batch_size=200, features_length=config["spectrogram_length"],
            truncation_strategy="default")
        quant_path = os.path.join(native_dir, "model_quant.mww")
        export_model(bundle, state, quant_path, quantize=True, calibration=calib)
        out["int8"] = quant_path
        print(f"native int8 streaming model: {quant_path}")
    except ValueError as e:
        print(f"native int8 export skipped: {e}")
    return out


def native_streaming_roc(bundle, model, feature_handler, config: dict, path: str,
                         folder: str, accuracy_name: str) -> dict:
    """The streamed ambient ROC of the ``.mww`` at ``path`` run by the C++
    runtime, one track at a time from a reset state."""
    from microwakeword_tpu_torch.evaluate.streaming_eval import streaming_model_roc
    from microwakeword_tpu_torch.native import StreamingRuntime

    runner = StreamingRuntime(path)

    def native_stream_fn(_model, x):
        runner.reset()
        return runner.predict_spectrogram(x[0])

    return streaming_model_roc(bundle, model, feature_handler, config, folder=folder,
                               accuracy_name=accuracy_name, stream_fn=native_stream_fn)


def run(flags, config: dict) -> dict:
    """Trains (``--train 1``), loads ``--use_weights``, evaluates and exports,
    as the JAX CLI does after reading its YAML.  Returns {"history",
    "streaming_roc", "accuracy", "native", "native_quantized_roc",
    "exported", "tflite"} (None where not run; "tflite" maps each
    ``--test_tflite_*`` flag set to its file).  Over a mesh every rank
    trains and scores the streamed ROC; rank 0 then evaluates and exports
    alone, and its result is returned."""
    from microwakeword_tpu_torch.data.store import FeatureHandler
    from microwakeword_tpu_torch.evaluate.streaming_eval import model_accuracy, streaming_model_roc
    from microwakeword_tpu_torch.models import build_model
    from microwakeword_tpu_torch.parallel import mesh as M
    from microwakeword_tpu_torch.train import loop as training

    size = M.mesh_size(flags.mesh, int(config.get("batch_size", 128)), flags.device)
    if size and not M.in_process_group():
        return M.launch(run, size, flags.device, flags, config)[0]
    mesh = M.create_mesh(size, flags.device) if size else None
    device = mesh.device if mesh is not None else resolve_device(flags.device)
    bundle = build_model(flags.model_name, config["model_config"])
    feature_handler = FeatureHandler(config, device)

    train_dir = config["train_dir"]
    out = {"history": None, "streaming_roc": None, "accuracy": None, "native": None,
           "native_quantized_roc": None, "exported": None, "tflite": None}
    if flags.train:
        _, out["history"] = training.train(
            bundle, config, feature_handler, restore_checkpoint=bool(flags.restore_checkpoint),
            device=device, mesh=mesh)
    elif not os.path.isdir(train_dir):
        raise ValueError('model is not trained; set "--train 1" and retrain')

    model = training.load_weights(bundle, os.path.join(train_dir, flags.use_weights + ".pt"), device)

    if flags.test_streaming and feature_handler.get_mode_size("testing_ambient"):
        out["streaming_roc"] = streaming_model_roc(
            bundle, model, feature_handler, config, folder=os.path.join(train_dir, "streaming"),
            accuracy_name="streaming_roc.txt", mesh=mesh)
        if mesh is None or mesh.is_main:
            print(f"streaming ROC AUC: {out['streaming_roc']['auc']:.5f}")
    if mesh is not None and not mesh.is_main:
        return out

    if flags.test_tf_nonstreaming and feature_handler.get_mode_size("testing"):
        out["accuracy"] = model_accuracy(
            bundle, model, feature_handler, config, data_set="testing",
            folder=os.path.join(train_dir, "non_stream"), accuracy_name="testing_set_metrics.txt")
        print(f"nonstreaming accuracy: {out['accuracy']['accuracy']:.4%}")

    native_dir = os.path.join(train_dir, "native")
    if flags.export_native:
        out["native"] = export_native(bundle, model, feature_handler, config, native_dir)
    if (flags.test_native_quantized and flags.export_native and out["native"]["int8"]
            and feature_handler.get_mode_size("testing_ambient")):
        out["native_quantized_roc"] = native_streaming_roc(
            bundle, model, feature_handler, config, out["native"]["int8"], native_dir,
            "quantized_streaming_roc.txt")
        print(f"native int8 streaming ROC AUC: {out['native_quantized_roc']['auc']:.5f}")

    if flags.export_stablehlo:
        from microwakeword_tpu_torch.export.torch_export import export_streaming

        export_dir = os.path.join(train_dir, "torch_export")
        os.makedirs(export_dir, exist_ok=True)
        path = os.path.join(export_dir, "model.mwwt")
        try:
            export_streaming(bundle, model.state_dict(), path)
            out["exported"] = path
            print(f"torch.export model: {path}")
        except ValueError as e:
            # e.g. spatial_attention without pooling has no streaming form
            print(f"torch.export export skipped: {e}")

    runs = {name: kind for name, kind in TFLITE_RUNS.items() if getattr(flags, name)}
    if runs:
        from microwakeword_tpu_torch.export.tflite import export_and_evaluate_tflite

        out["tflite"] = {
            name: export_and_evaluate_tflite(bundle, model, feature_handler, config, train_dir,
                                             quantize=quantize, streaming=streaming)
            for name, (quantize, streaming) in runs.items()}
    return out


def main(argv=None) -> dict:
    import yaml

    from microwakeword_tpu_torch.config import load_config

    flags = build_parser().parse_args(argv)
    config = load_config(flags.training_config, model_config_from_flags(flags))
    config["flags"] = vars(flags)
    if flags.train and int(os.environ.get("RANK", 0)) == 0:  # torchrun's rank 0, or alone
        os.makedirs(config["train_dir"], exist_ok=True)
        with open(os.path.join(config["train_dir"], "training_config.yaml"), "w") as f:
            dump = {k: v for k, v in config.items() if k != "model_config"}
            yaml.safe_dump(dump, f, default_flow_style=False)
    return run(flags, config)


if __name__ == "__main__":
    main()
