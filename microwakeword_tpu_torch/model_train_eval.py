"""CLI entry point: train and evaluate wake-word models on the card (port of
model_train_eval.py).

    python -m microwakeword_tpu_torch.model_train_eval \\
        --training_config=training_parameters.yaml --train 1 \\
        mixednet --pointwise_filters "64,64,64,64" --stride 3 ...

The flags are the JAX CLI's, with the reference's per-model subparsers and
string-list flags, plus ``--device`` (default ``cuda``; ``--device cpu``
runs on the CPU).  ``main`` parses the flags and the YAML and writes
``training_config.yaml``; ``run`` does the rest and needs no PyYAML.  Exports
and the runners that read them are not ported yet: their flags default to 0
here and raise if set (ROADMAP queue item 6).
"""

from __future__ import annotations

import argparse
import ast
import os

from microwakeword_tpu_torch.device import resolve_device

_EXPORT_FLAGS = (
    "test_tflite_nonstreaming", "test_tflite_nonstreaming_quantized", "test_tflite_streaming",
    "test_tflite_streaming_quantized", "export_native", "test_native_quantized", "export_stablehlo",
)
_NOT_PORTED = "not ported yet (ROADMAP queue item 6, exports): setting it to 1 raises"


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
    for name in _EXPORT_FLAGS:
        parser.add_argument(f"--{name}", type=int, default=0, help=_NOT_PORTED)
    parser.add_argument("--mesh", type=str, default="auto",
                        help="'auto' or 'off' (one device), or a device count; more than "
                             "one device is not ported yet (ROADMAP queue item 7)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to train and evaluate on: cuda (default) or cpu")
    sub = parser.add_subparsers(dest="model_name", required=True)
    add_mixednet_flags(sub.add_parser("mixednet"))
    add_inception_flags(sub.add_parser("inception"))
    return parser


def model_config_from_flags(flags):
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
        raise NotImplementedError("the Inception model is not ported yet: ROADMAP queue item 3")
    raise ValueError(f"unknown model {flags.model_name!r}")


def _mesh_devices(mesh: str) -> int:
    if mesh in ("auto", "off"):
        return 1
    count = int(mesh)
    if count > 1:
        raise NotImplementedError(
            f"--mesh {count}: more than one device is not ported yet: ROADMAP queue item 7")
    return count


def run(flags, config: dict) -> dict:
    """Trains (``--train 1``), loads ``--use_weights`` and evaluates, as the
    JAX CLI does after reading its YAML.  Returns {"history", "streaming_roc",
    "accuracy"} (None where not run)."""
    from microwakeword_tpu_torch.data.store import FeatureHandler
    from microwakeword_tpu_torch.evaluate.streaming_eval import model_accuracy, streaming_model_roc
    from microwakeword_tpu_torch.models import build_model
    from microwakeword_tpu_torch.train import loop as training

    for name in _EXPORT_FLAGS:
        if getattr(flags, name):
            raise NotImplementedError(f"--{name}: {_NOT_PORTED}")
    mesh = _mesh_devices(flags.mesh)
    device = resolve_device(flags.device)
    bundle = build_model(flags.model_name, config["model_config"])
    feature_handler = FeatureHandler(config, device)

    train_dir = config["train_dir"]
    out = {"history": None, "streaming_roc": None, "accuracy": None}
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
            accuracy_name="streaming_roc.txt")
        print(f"streaming ROC AUC: {out['streaming_roc']['auc']:.5f}")

    if flags.test_tf_nonstreaming and feature_handler.get_mode_size("testing"):
        out["accuracy"] = model_accuracy(
            bundle, model, feature_handler, config, data_set="testing",
            folder=os.path.join(train_dir, "non_stream"), accuracy_name="testing_set_metrics.txt")
        print(f"nonstreaming accuracy: {out['accuracy']['accuracy']:.4%}")
    return out


def main(argv=None) -> dict:
    import yaml

    from microwakeword_tpu_torch.config import load_config

    flags = build_parser().parse_args(argv)
    config = load_config(flags.training_config, model_config_from_flags(flags))
    config["flags"] = vars(flags)
    if flags.train:
        os.makedirs(config["train_dir"], exist_ok=True)
        with open(os.path.join(config["train_dir"], "training_config.yaml"), "w") as f:
            dump = {k: v for k, v in config.items() if k != "model_config"}
            yaml.safe_dump(dump, f, default_flow_style=False)
    return run(flags, config)


if __name__ == "__main__":
    main()
