"""The port's data store, CLI and streamed evaluation on a tiny synthetic
store, against the JAX package where it has a counterpart.

- ``FeatureHandler.get_data`` equals JAX's for truncate_start, split and
  none with the same numpy generator;
- a CLI run on the CPU (``--device cpu``) writes the JAX CLI's artifact
  names and resumes from ``restore/ckpt.pt``;
- ``streaming_model_roc`` and ``model_accuracy`` equal JAX's on the same
  weights and store (AUC and curves to 1e-6);
- raw-audio training (clips-type sets, alone, mixed with mmap sets, and
  with pool refresh) learns the JAX package's tone task through the CLI;
- the Inception family trains through the CLI, and the default
  ``--export_native 1`` writes both ``.mww`` files, which the C++ runtime
  runs like the port's ``stream_scan``;
- ``--export_stablehlo`` writes ``torch_export/model.mwwt`` and
  ``--test_tflite_streaming_quantized`` the int8 ``.tflite`` and its ESPHome
  manifest;
- ``--device cpu --mesh 2`` trains on two gloo ranks, rank 0 alone writes
  the artifacts, and the weights equal ``--mesh off``'s; ``sweep --mesh 2``'s
  members equal the solo sweep's;
- pool refresh over a mesh refuses a spectrogram corpus as the solo run
  does (ValueError), in a gloo group of one rank in this process.
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch
import yaml

from microwakeword_tpu.data.ragged_store import RaggedSpectrogramStore as JaxStore
from microwakeword_tpu.data.store import FeatureHandler as JaxFeatureHandler
from microwakeword_tpu.evaluate import streaming_eval as JE
from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxConfig
from microwakeword_tpu_torch import model_train_eval as CLI
from microwakeword_tpu_torch.audio.io import save_clip
from microwakeword_tpu_torch.config import derive_config
from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu_torch.data.store import FeatureHandler
from microwakeword_tpu_torch.evaluate import streaming_eval as E
from microwakeword_tpu_torch.models import build_model, convert
from microwakeword_tpu_torch.train import loop as T

torch.set_num_threads(2)

MODEL_FLAGS = ["mixednet", "--pointwise_filters", "12,12", "--repeat_in_block", "1,1",
               "--mixconv_kernel_sizes", "[3], [5]", "--residual_connection", "0,0",
               "--first_conv_filters", "8", "--first_conv_kernel_size", "3", "--stride", "1"]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """(root, config): positives carry energy in the high channels,
    negatives in the low ones (tests/test_cli.py's pattern)."""
    root = tmp_path_factory.mktemp("cli_store")
    rng = np.random.default_rng(0)

    def make(n, positive, lo, hi):
        out = []
        for _ in range(n):
            spec = rng.uniform(0, 80, size=(int(rng.integers(lo, hi)), 40))
            spec[:, 20:] += 300 if positive else 0
            spec[:, :20] += 0 if positive else 300
            out.append(spec.astype(np.uint16))
        return out

    for name, positive, modes in [
        ("pos", True, {"training": 24, "validation": 8, "testing": 5}),
        ("neg", False, {"training": 20, "validation": 6, "testing": 4,
                        "validation_ambient": 2, "testing_ambient": 2}),
    ]:
        for mode, n in modes.items():
            lo, hi = (500, 600) if mode.endswith("ambient") else (30, 70)
            RaggedSpectrogramStore.create(str(root / name / mode / "w_mmap"), make(n, positive, lo, hi))
    config = {
        "train_dir": str(root / "run"), "clip_duration_ms": 390, "window_step_ms": 10,
        "batch_size": 16, "training_steps": [12, 8], "learning_rates": [0.01, 0.002],
        "eval_step_interval": 10, "seed": 3, "steps_per_call": 3,
        "minimization_metric": "ambient_false_positives_per_hour",
        "maximization_metric": "average_viable_recall", "target_minimization": 0.9,
        "features": [
            {"features_dir": str(root / "pos"), "truth": True, "sampling_weight": 1.0,
             "penalty_weight": 1.0, "truncation_strategy": "truncate_start", "type": "mmap"},
            {"features_dir": str(root / "neg"), "truth": False, "sampling_weight": 1.0,
             "penalty_weight": 1.0, "truncation_strategy": "random", "type": "mmap",
             "fixed_right_cutoffs": [0, 4]},
        ],
    }
    with open(root / "training_parameters.yaml", "w") as f:
        yaml.safe_dump(config, f)
    return root, config


@pytest.fixture(scope="module")
def trained(store):
    """One CLI run on the CPU: (flags, derived config, run() result)."""
    root, _ = store
    argv = ["--training_config", str(root / "training_parameters.yaml"), "--device", "cpu",
            "--test_tf_nonstreaming", "1"] + MODEL_FLAGS
    out = CLI.main(argv)
    flags = CLI.build_parser().parse_args(argv)
    with open(root / "training_parameters.yaml") as f:
        config = derive_config(yaml.safe_load(f), CLI.model_config_from_flags(flags))
    return flags, config, out


@pytest.mark.parametrize("mode,strategy", [
    ("validation", "truncate_start"), ("validation_ambient", "split"), ("testing", "none"),
    ("testing_ambient", "none"), ("validation", "fixed_right_cutoff"),
])
def test_get_data_matches_jax(store, mode, strategy):
    _, config = store
    config = dict(config, stride=3)
    want = JaxFeatureHandler(config).get_data(mode, 16, 37, strategy, rng=np.random.default_rng(7))
    got = FeatureHandler(config).get_data(mode, 16, 37, strategy, rng=np.random.default_rng(7))
    if strategy == "none":
        assert len(got[0]) == len(want[0]) > 0
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
    else:
        assert got[0].shape == want[0].shape and len(got[0]) > 0
        np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_store_reads_jax_written_store(tmp_path):
    specs = [np.arange(t * 40, dtype=np.uint16).reshape(t, 40) for t in (3, 9, 1)]
    JaxStore.create(str(tmp_path / "s_mmap"), specs)
    store = RaggedSpectrogramStore(str(tmp_path / "s_mmap"))
    assert len(store) == 3 and store.total_frames == 13
    for got, want in zip(store, specs):
        np.testing.assert_array_equal(got, want)


def test_cli_writes_artifacts(store, trained):
    root, _ = store
    _, _, out = trained
    run = root / "run"
    for name in ("best_weights.pt", "last_weights.pt", "restore/ckpt.pt", "training_config.yaml",
                 "model_summary.txt", "metrics.jsonl", "streaming/streaming_roc.txt",
                 "non_stream/testing_set_metrics.txt", "native/model.mww",
                 "native/model_quant.mww"):
        assert (run / name).exists(), name
    assert any(p.name.endswith("_weights_10.pt") for p in (run / "train").iterdir())
    records = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [10, 20]
    assert records[-1]["train"]["accuracy"] > 0.85
    assert np.isfinite(out["streaming_roc"]["auc"]) and out["accuracy"]["accuracy"] > 0.8
    assert "Total trainable params" in (run / "model_summary.txt").read_text()


def test_cli_resumes_from_restore_checkpoint(store, trained, tmp_path):
    root, config = store
    _, derived, _ = trained
    ckpt = torch.load(root / "run" / "restore" / "ckpt.pt", weights_only=True)
    assert ckpt["step"] == 20 and int(ckpt["opt_state"]["count"]) == 20
    resumed = dict(config, train_dir=str(tmp_path / "resumed"), training_steps=[10])
    os.makedirs(tmp_path / "resumed" / "restore")
    torch.save(ckpt, tmp_path / "resumed" / "restore" / "ckpt.pt")
    with open(tmp_path / "resumed.yaml", "w") as f:
        yaml.safe_dump(resumed, f)
    out = CLI.main(["--training_config", str(tmp_path / "resumed.yaml"), "--device", "cpu",
                    "--restore_checkpoint", "1", "--test_streaming", "0"] + MODEL_FLAGS)
    assert [r["step"] for r in out["history"]] == [30]  # the step offset is added
    assert out["history"][-1]["train"]["accuracy"] > 0.85
    restored = torch.load(tmp_path / "resumed" / "restore" / "ckpt.pt", weights_only=True)
    assert int(restored["opt_state"]["count"]) == 30  # Adam's count went on from 20
    # the same run from a fresh init ends elsewhere
    bundle = build_model("mixednet", derived["model_config"])
    fresh_config = derive_config(dict(resumed, train_dir=str(tmp_path / "fresh")),
                                 derived["model_config"])
    fresh, _ = T.train(bundle, fresh_config, FeatureHandler(fresh_config), device="cpu")
    last = torch.load(tmp_path / "resumed" / "last_weights.pt", weights_only=True)
    assert not all(torch.equal(last[k], v) for k, v in fresh.state_dict().items())


@pytest.fixture(scope="module")
def twin(trained):
    """The JAX bundle (its stream_scan and forward jitted, so that the scan
    compiles once per length bucket), the CLI run's best weights as flax
    variables, the port bundle and module."""
    _, config, _ = trained
    tb = build_model("mixednet", config["model_config"])
    model = T.load_weights(tb, os.path.join(config["train_dir"], "best_weights.pt"), device="cpu")
    cfg = config["model_config"]
    jb = jax_build_model("mixednet", JaxConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__}))
    variables = convert.state_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    jitted = types.SimpleNamespace(stride=jb.stride, stream_scan=jax.jit(jb.stream_scan),
                                   forward=jax.jit(jb.forward))
    return jitted, variables, tb, model


def test_streaming_model_roc_matches_jax(trained, twin):
    _, config, _ = trained
    jb, variables, tb, model = twin
    want = JE.streaming_model_roc(jb, variables, JaxFeatureHandler(config), config)
    got = E.streaming_model_roc(tb, model, FeatureHandler(config), config)
    assert got["positive_count"] == want["positive_count"] == 5
    assert got["auc"] == pytest.approx(want["auc"], abs=1e-6)
    for key in ("x_faph", "y_frr", "cutoffs", "faph_at_cutoffs", "frr_at_cutoffs"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)


def test_streaming_model_roc_stream_fn(trained, twin):
    """A ``stream_fn`` replaces only the source of the probabilities: the
    port's own scan given as one yields the same curve."""
    _, config, _ = trained
    _, _, tb, model = twin
    want = E.streaming_model_roc(tb, model, FeatureHandler(config), config)
    got = E.streaming_model_roc(tb, model, FeatureHandler(config), config,
                                stream_fn=lambda m, x: tb.stream_scan(m, torch.from_numpy(x)))
    assert got["auc"] == want["auc"]
    for key in ("x_faph", "y_frr", "faph_at_cutoffs", "frr_at_cutoffs"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("data_set,use_streaming", [
    ("testing", False), ("testing", True), ("testing_ambient", False)])
def test_model_accuracy_matches_jax(trained, twin, data_set, use_streaming):
    _, config, _ = trained
    jb, variables, tb, model = twin
    want = JE.model_accuracy(jb, variables, JaxFeatureHandler(config), config, data_set=data_set,
                             use_streaming=use_streaming)
    got = E.model_accuracy(tb, model, FeatureHandler(config), config, data_set=data_set,
                           use_streaming=use_streaming)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float) and np.isnan(value):
            assert np.isnan(got[key]), key
        else:
            assert got[key] == pytest.approx(value, abs=1e-6), key


def test_cli_flags_not_ported_raise(store, tmp_path):
    """``--device cpu --mesh 2`` (it raised before its slice): two gloo ranks
    train the run, rank 0 alone writes the artifacts and metrics.jsonl (one
    record per eval), the streamed ROC is the solo run's, and the final
    parameters equal ``--mesh off``'s within 2e-5 (tests/test_parallel.py's
    bound for the JAX package), the BatchNorm statistics (variances up to
    about 60) within 2e-5 relative."""
    _, config = store
    outs = {}
    for mesh in ("2", "off"):
        with open(tmp_path / f"{mesh}.yaml", "w") as f:
            yaml.safe_dump(dict(config, train_dir=str(tmp_path / mesh)), f)
        outs[mesh] = CLI.main(["--training_config", str(tmp_path / f"{mesh}.yaml"), "--device",
                               "cpu", "--mesh", mesh, "--export_native", "0",
                               "--export_stablehlo", "0"] + MODEL_FLAGS)
    run = tmp_path / "2"
    for name in ("best_weights.pt", "last_weights.pt", "restore/ckpt.pt", "training_config.yaml",
                 "model_summary.txt", "metrics.jsonl", "streaming/streaming_roc.txt"):
        assert (run / name).exists(), name
    records = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [r["step"] for r in outs["off"]["history"]] == [10, 20]
    for got, want in zip(records, outs["off"]["history"]):
        assert got["train"]["loss"] == pytest.approx(want["train"]["loss"], rel=1e-4)
    assert outs["2"]["streaming_roc"]["auc"] == pytest.approx(outs["off"]["streaming_roc"]["auc"],
                                                              abs=1e-6)
    got = torch.load(run / "last_weights.pt", weights_only=True)
    want = torch.load(tmp_path / "off" / "last_weights.pt", weights_only=True)
    assert set(got) == set(want)
    for key, value in want.items():
        stat = key.endswith((".mean", ".var"))
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=2e-5 if stat else 0,
                                   atol=1e-6 if stat else 2e-5, err_msg=key)


def test_cli_exports_mwwt_tflite_and_manifest(store, trained):
    """``--export_stablehlo 1 --test_tflite_streaming_quantized 1`` on the
    trained run: ``torch_export/model.mwwt`` serves like the weights, and the
    int8 streaming ``.tflite``, its scores and its ESPHome manifest are
    written under the JAX CLI's names."""
    pytest.importorskip("tensorflow")
    from microwakeword_tpu_torch.export.torch_export import ExportedModel

    root, _ = store
    flags, config, _ = trained
    run_dir = root / "run"
    out = CLI.main(["--training_config", str(root / "training_parameters.yaml"), "--device", "cpu",
                    "--train", "0", "--export_native", "0", "--export_stablehlo", "1",
                    "--test_tflite_streaming_quantized", "1"] + MODEL_FLAGS)
    assert out["exported"] == str(run_dir / "torch_export" / "model.mwwt")
    bundle = build_model("mixednet", config["model_config"])
    model = T.load_weights(bundle, str(run_dir / "best_weights.pt"), device="cpu")
    x = torch.rand(3, config["spectrogram_length"], 40) * 20
    with torch.no_grad():
        np.testing.assert_allclose(ExportedModel(out["exported"], "cpu").forward(x).numpy(),
                                   bundle.forward(model, x).numpy(), atol=1e-6)
    folder = run_dir / "tflite_stream_state_internal_quant"
    assert out["tflite"] == {"test_tflite_streaming_quantized":
                             str(folder / "stream_state_internal_quant.tflite")}
    for name in ("stream_state_internal_quant.tflite", "tflite_streaming_roc.txt",
                 "tflite_model_accuracy.txt", "tflite_ambient_false_accepts.txt", "run.json"):
        assert (folder / name).exists(), name
    with open(folder / "run.json") as f:
        manifest = json.load(f)
    assert manifest["model"] == "stream_state_internal_quant.tflite"
    assert manifest["wake_word"] == "run" and manifest["version"] == 2
    assert 0.0 <= manifest["micro"]["probability_cutoff"] <= 1.0
    assert manifest["micro"]["feature_step_size"] == config["window_step_ms"]


def _sweep_config(root, config, name):
    """The store's YAML with its own train_dir and one step per call."""
    path = root / f"{name}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(dict(config, train_dir=str(root / name), steps_per_call=1), f)
    return str(path)


def test_sweep_cli(store):
    """python -m microwakeword_tpu_torch.sweep on the CPU: a member directory
    of loadable weights each, the JAX sweep's leaderboard keys and order of
    fields, sweep_config.yaml; with --mesh 2 two gloo ranks train two members
    each, and the members and the leaderboard equal the solo sweep's."""
    from microwakeword_tpu import sweep as jax_sweep
    from microwakeword_tpu_torch import sweep

    root, config = store
    common = ["--n_models", "3", "--steps", "6", "--seeds", "4,5", "--learning_rates",
              "0.01,0.005"]
    assert jax_sweep.main(["--training_config", _sweep_config(root, config, "jax_sweep"),
                           "--mesh", "off"] + common + MODEL_FLAGS) == 0
    assert sweep.main(["--training_config", _sweep_config(root, config, "sweep"), "--device",
                       "cpu"] + common + MODEL_FLAGS) == 0
    with open(root / "jax_sweep" / "leaderboard.json") as f:
        want = json.load(f)
    with open(root / "sweep" / "leaderboard.json") as f:
        got = json.load(f)
    assert len(got) == 3 and sorted(row["member"] for row in got) == [0, 1, 2]
    assert [list(row) for row in got] == [list(row) for row in want]
    assert [sorted(row["metrics"]) for row in got] == [sorted(row["metrics"]) for row in want]
    with open(root / "sweep" / "sweep_config.yaml") as f:
        recorded = yaml.safe_load(f)
    with open(root / "jax_sweep" / "sweep_config.yaml") as f:
        assert recorded == yaml.safe_load(f)
    assert recorded["seeds"] == [4, 5, 4] and recorded["steps"] == 6
    flags = sweep.build_parser().parse_args(["--training_config", "unused.yaml"] + MODEL_FLAGS)
    derived = derive_config(config, CLI.model_config_from_flags(flags))
    bundle = build_model("mixednet", derived["model_config"])
    x = torch.rand(4, derived["spectrogram_length"], 40) * 20
    probs = []
    for i in range(3):
        model = T.load_weights(bundle, str(root / "sweep" / f"member_{i:02d}" / "best_weights.pt"),
                               device="cpu")
        with torch.no_grad():
            probs.append(bundle.forward(model, x))
    assert all(bool(torch.isfinite(p).all()) for p in probs)
    assert not torch.equal(probs[0], probs[1])
    four = ["--n_models", "4"] + common[2:]
    for name, mesh in (("sweep_solo4", "off"), ("sweep_mesh", "2")):
        assert sweep.main(["--training_config", _sweep_config(root, config, name), "--device",
                           "cpu", "--mesh", mesh] + four + MODEL_FLAGS) == 0
    with open(root / "sweep_mesh" / "leaderboard.json") as f:
        got = json.load(f)
    with open(root / "sweep_solo4" / "leaderboard.json") as f:
        want = json.load(f)
    assert [row["member"] for row in got] == [row["member"] for row in want]
    for a, b in zip(got, want):
        assert a["best_step"] == b["best_step"]
        assert a["maximization"] == pytest.approx(b["maximization"], abs=1e-6)
    for i in range(4):
        a, b = (torch.load(root / name / f"member_{i:02d}" / "best_weights.pt", weights_only=True)
                for name in ("sweep_mesh", "sweep_solo4"))
        for key in b:
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), atol=2e-5, err_msg=key)


INCEPTION_FLAGS = ["inception", "--cnn1_filters", "8", "--cnn1_kernel_sizes", "3",
                   "--cnn1_subspectral_groups", "4", "--cnn2_filters1", "6,8",
                   "--cnn2_filters2", "8,8", "--cnn2_kernel_sizes", "3,3",
                   "--cnn2_subspectral_groups", "1,2", "--cnn2_dilation", "1,2"]


def test_inception_raises(store, tmp_path):
    """Inception through the CLI on the CPU (it raised before its slice):
    the JAX run's artifact names, ``native/model.mww`` and the int8 file
    from the default ``--export_native 1``, the int8 file's streamed ROC
    through the runtime, and the float file run by the runtime like the
    port's ``stream_scan`` on a test ambient track."""
    from microwakeword_tpu_torch.native import StreamingRuntime

    root, config = store
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(dict(config, train_dir=str(tmp_path / "run")), f)
    argv = ["--training_config", str(tmp_path / "cfg.yaml"), "--device", "cpu",
            "--test_native_quantized", "1"] + INCEPTION_FLAGS
    out = CLI.main(argv)
    run = tmp_path / "run"
    for name in ("best_weights.pt", "last_weights.pt", "restore/ckpt.pt", "training_config.yaml",
                 "model_summary.txt", "metrics.jsonl", "streaming/streaming_roc.txt",
                 "native/model.mww", "native/model_quant.mww",
                 "native/quantized_streaming_roc.txt"):
        assert (run / name).exists(), name
    assert out["native"] == {"float": str(run / "native" / "model.mww"),
                             "int8": str(run / "native" / "model_quant.mww")}
    assert np.isfinite(out["streaming_roc"]["auc"])
    assert np.isfinite(out["native_quantized_roc"]["auc"])
    assert out["history"][-1]["train"]["accuracy"] > 0.85
    flags = CLI.build_parser().parse_args(argv)
    derived = derive_config(config, CLI.model_config_from_flags(flags))
    bundle = build_model("inception", derived["model_config"])
    model = T.load_weights(bundle, str(run / "best_weights.pt"), device="cpu")
    track = FeatureHandler(derived).get_data("testing_ambient", 16, bundle.spectrogram_length,
                                             "none")[0][0]
    want = bundle.stream_scan(model, torch.from_numpy(track.astype(np.float32))[None])
    got = StreamingRuntime(str(run / "native" / "model.mww")).predict_spectrogram(track)
    np.testing.assert_allclose(got, want.reshape(-1).numpy(), rtol=2e-4, atol=2e-5)


def test_train_options_not_ported_raise(trained, tmp_path):
    """Pool refresh over a mesh raised NotImplementedError before its slice;
    now a mesh takes it, and, as the solo run and the JAX package's mesh
    train() do, refuses a replicated spectrogram corpus with it (ValueError:
    refresh rebuilds raw-audio pools).  A mesh of one gloo rank in this
    process; refresh over two ranks: tests/test_torch_parallel.py."""
    from microwakeword_tpu_torch.parallel import mesh as M

    _, config, _ = trained
    config = dict(config, train_dir=str(tmp_path / "run"), pool_refresh_steps=10)
    mesh = M.init_mesh(1, 0, "cpu", init_method=f"tcp://localhost:{M.free_port()}")
    try:
        with pytest.raises(ValueError, match="requires raw-audio training"):
            T.train(build_model("mixednet", config["model_config"]), config,
                    FeatureHandler(config), device="cpu", mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("option,match", [
    ({"frontend_backend": "tpu"}, "frontend_backend must be one of"),
    ({"pool_refresh_steps": 10}, "requires raw-audio training"),  # a spectrogram corpus
])
def test_train_options_refused(trained, tmp_path, option, match):
    _, config, _ = trained
    config = dict(config, train_dir=str(tmp_path / "run"), **option)
    with pytest.raises(ValueError, match=match):
        T.train(build_model("mixednet", config["model_config"]), config, FeatureHandler(config),
                device="cpu")


# ---- raw-audio and mixed training (tests/test_data.py:380, 477, 578) -------


@pytest.fixture(scope="module")
def audio_root(tmp_path_factory):
    """pos/ and neg/ WAVs of pulsed tones (the frontend's noise suppression
    removes stationary signals, so the separable signal is transient), and
    spec_neg/, precomputed negatives with low-channel energy."""
    root = tmp_path_factory.mktemp("cli_audio")
    rng = np.random.default_rng(0)
    t = np.arange(24000)
    gate = (np.sin(2 * np.pi * 8.0 * t / 16000) > 0).astype(np.float32)
    for name, freqs in (("pos", (2000, 2400)), ("neg", (200, 300))):
        (root / name).mkdir()
        for i, f0 in enumerate(freqs):
            tone = 0.4 * gate * np.sin(2 * np.pi * f0 * t / 16000) + 0.004 * rng.standard_normal(len(t))
            save_clip(tone.astype(np.float32), str(root / name / f"c{i}.wav"))
    negs = []
    for _ in range(12):
        spec = rng.uniform(0, 60, size=(int(rng.integers(45, 70)), 40))
        spec[:, :12] += 250
        negs.append(spec.astype(np.uint16))
    RaggedSpectrogramStore.create(str(root / "spec_neg" / "training" / "x_mmap"), negs)
    return root


def _clips_feature(root, name, truth, seed):
    return {"type": "clips", "truth": truth, "sampling_weight": 1.0, "penalty_weight": 1.0,
            "truncation_strategy": "random", "pack_pool_size": 8,
            "clips_settings": {"input_directory": str(root / name), "file_pattern": "*.wav",
                               "seed": seed},
            "augmentation_settings": {"augmentation_duration_s": 1.5, "seed": seed + 1,
                                      "augmentation_probabilities": {"Gain": 1.0}},
            "spectrogram_generation_settings": {"step_ms": 10}}


@pytest.mark.parametrize("kind", ["raw_audio", "mixed", "raw_audio_refresh"])
def test_cli_trains_on_audio(audio_root, tmp_path, kind):
    """``raw_audio_training: true`` through the CLI on the CPU: clips-type
    sets alone (the xla backend name), clips-type positives with mmap
    negatives (the pallas name), and clips-type sets whose pools refresh
    every 10 steps; each learns the separable task."""
    negatives = (_clips_feature(audio_root, "neg", False, 5) if kind != "mixed" else
                 {"type": "mmap", "features_dir": str(audio_root / "spec_neg"), "truth": False,
                  "sampling_weight": 1.0, "penalty_weight": 0.5, "truncation_strategy": "random"})
    config = {"train_dir": str(tmp_path / "run"), "clip_duration_ms": 390, "window_step_ms": 10,
              "batch_size": 16, "raw_audio_training": True, "seed": 1,
              "training_steps": [120 if kind == "raw_audio_refresh" else 80],
              "learning_rates": [0.02], "eval_step_interval": 40,
              "frontend_backend": "pallas" if kind == "mixed" else "xla",
              "features": [_clips_feature(audio_root, "pos", True, 3), negatives]}
    if kind == "raw_audio_refresh":
        config["pool_refresh_steps"] = 10
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(config, f)
    out = CLI.main(["--training_config", str(tmp_path / "cfg.yaml"), "--device", "cpu"]
                   + MODEL_FLAGS)
    final = out["history"][-1]
    assert np.isfinite(final["train"]["loss"])
    assert final["train"]["accuracy"] > 0.9, final
    if kind == "raw_audio_refresh":
        assert final["pool_swaps"] >= 1
    assert (tmp_path / "run" / "best_weights.pt").exists()
