"""The port stands alone: it imports no jax/flax/optax and nothing of
microwakeword_tpu, and its entry points run on the CUDA card unless the
caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from microwakeword_tpu_torch import model_train_eval as CLI
from microwakeword_tpu_torch.config import derive_config
from microwakeword_tpu_torch.export import native_runtime
from microwakeword_tpu_torch.frontend import plain
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import build_model, presets
from microwakeword_tpu_torch.train import loop

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "microwakeword_tpu")

_PROBE = """
import json, os, sys, tempfile
before = set(sys.modules)
import numpy as np
import torch
torch.set_num_threads(2)
from microwakeword_tpu_torch import build_dataset, model_train_eval
from microwakeword_tpu_torch.audio import augmentation, clips, dsp, io, spectrograms, vad
from microwakeword_tpu_torch.config import derive_config
from microwakeword_tpu_torch.data import sampler
from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu_torch.data.refresh import PoolRefresher
from microwakeword_tpu_torch.data.store import FeatureHandler
from microwakeword_tpu_torch.export import native_quant, native_runtime
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import MixedNetConfig, build_model, presets
from microwakeword_tpu_torch.train import loop
from microwakeword_tpu_torch import sweep
from microwakeword_tpu_torch.data import host_stream
from microwakeword_tpu_torch.parallel import population
from microwakeword_tpu_torch.export import manifest, tflite, torch_export
from microwakeword_tpu_torch import native
from microwakeword_tpu_torch.frontend import fixedpoint, reference
bundle = build_model("mixednet", presets.flagship_config())
model = bundle.init(torch.Generator().manual_seed(0), device="cpu")
state = {k: v.numpy() for k, v in model.state_dict().items()}
audio = np.random.default_rng(0).integers(-8000, 8000, 8000).astype(np.int16)
probs = Model.from_torch(bundle, state, device="cpu").predict_clip(audio)
assert probs.shape == (48 // 3,), probs.shape
root = tempfile.mkdtemp()
inception = build_model("inception", presets.default_inception_config())
istate = inception.init(torch.Generator().manual_seed(0), device="cpu").state_dict()
native_runtime.export_model(inception, istate, os.path.join(root, "inc.mww"))
native_runtime.export_model(inception, istate, os.path.join(root, "inc_q.mww"), quantize=True)
for name in ("inc.mww", "inc_q.mww"):
    probs = Model.from_native(os.path.join(root, name), 20, device="cpu").predict_clip(audio, 20)
    assert probs.shape == (24,), probs.shape
rng = np.random.default_rng(0)
for name in ("pos", "neg"):
    for mode in ("training", "validation"):
        RaggedSpectrogramStore.create(os.path.join(root, name, mode, "w_mmap"),
                                      [rng.integers(0, 600, (40, 40)) for _ in range(4)])
config = derive_config({
    "train_dir": os.path.join(root, "run"), "clip_duration_ms": 390, "window_step_ms": 10,
    "batch_size": 4, "training_steps": [2], "eval_step_interval": 2, "features": [
        {"features_dir": os.path.join(root, name), "truth": name == "pos", "sampling_weight": 1.0,
         "penalty_weight": 1.0, "truncation_strategy": "random"} for name in ("pos", "neg")]},
    MixedNetConfig(pointwise_filters=(8,), repeat_in_block=(1,), mixconv_kernel_sizes=((3,),),
                   residual_connection=(False,), first_conv_filters=4))
small = build_model("mixednet", config["model_config"])
_, history = loop.train(small, config, FeatureHandler(config), device="cpu")
assert [r["step"] for r in history] == [2], history
host = dict(config, corpus_residency="host", train_dir=os.path.join(root, "host"))
_, history = loop.train(small, host, FeatureHandler(host), device="cpu")
assert [r["step"] for r in history] == [2], history
packed = sampler.pack_training_data(FeatureHandler(config).providers, "cpu")
stacked, history = population.train_population(small, packed, 2, 2, 4, config["spectrogram_length"],
                                               device="cpu")
assert history[-1]["loss"].shape == (2,), history
trained = loop.load_weights(small, os.path.join(root, "run", "best_weights.pt"), "cpu")
torch_export.export_streaming(small, trained.state_dict(), os.path.join(root, "small.mwwt"))
probs = Model.from_exported(os.path.join(root, "small.mwwt"), device="cpu").predict_clip(audio)
assert probs.shape == (48,), probs.shape
wav = os.path.join(root, "a.wav")
native.wav_write_16k_i16(wav, audio)
assert np.array_equal(io.load_audio(wav), audio / np.float32(32768.0))
for fe in (reference.MicroFrontend(device="cpu"), fixedpoint.MicroFrontendInt(device="cpu")):
    assert tuple(fe.process_clip(audio).shape) == (48, 40)
assert "tensorflow" not in sys.modules  # only the TFLite functions import it
added = set(sys.modules) - before
print(json.dumps(sorted(added)))
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_and_predict_load_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert "microwakeword_tpu_torch" in added
    for name in ("train.loop", "build_dataset", "data.refresh", "audio.io", "audio.vad", "audio.dsp",
                 "audio.augmentation", "audio.clips", "audio.spectrograms", "models.inception",
                 "export.native_runtime", "export.native_quant", "native", "data.host_stream",
                 "parallel.population", "sweep", "export.manifest", "export.tflite",
                 "export.torch_export", "frontend.reference", "frontend.fixedpoint"):
        assert f"microwakeword_tpu_torch.{name}" in added, name
    assert [m for m in added if _forbidden(m)] == []
    assert "yaml" not in added  # only the CLI's main() reads YAML


def _sources():
    yield from sorted((REPO / "microwakeword_tpu_torch").rglob("*.py"))
    yield REPO / "chip_smoke.py"


def test_scan_covers_the_audio_path():
    """The scan below reaches the modules that the JAX package backs with
    its native library (``microwakeword_tpu.native``): the port keeps its own
    NumPy and SciPy copies of them."""
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    for name in ("audio/io.py", "audio/vad.py", "audio/dsp.py", "audio/augmentation.py",
                 "audio/clips.py", "audio/spectrograms.py", "build_dataset.py", "data/refresh.py",
                 "data/store.py", "data/sampler.py"):
        assert f"microwakeword_tpu_torch/{name}" in scanned, name


def test_scan_covers_the_population_path():
    """The scan below reaches population training, the sweep CLI and host
    streaming."""
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    for name in ("parallel/__init__.py", "parallel/population.py", "sweep.py",
                 "data/host_stream.py"):
        assert f"microwakeword_tpu_torch/{name}" in scanned, name


def test_scan_covers_the_deployment_exports():
    """The scan below reaches the TFLite exporter, the ESPHome manifest, the
    ``torch.export`` artifact and the host I/O bindings."""
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    for name in ("export/tflite.py", "export/manifest.py", "export/torch_export.py",
                 "native.py", "inference.py", "audio/io.py", "audio/vad.py"):
        assert f"microwakeword_tpu_torch/{name}" in scanned, name


def test_scan_covers_the_export_path():
    """The scan below reaches the Inception model, the exporters and the
    port's own binding of the C++ runtime (the JAX package's is
    ``microwakeword_tpu.native``, which the port may not import)."""
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    for name in ("models/inception.py", "export/native_runtime.py", "export/native_quant.py",
                 "native.py", "_build.py"):
        assert f"microwakeword_tpu_torch/{name}" in scanned, name


def test_scan_covers_the_host_frontends():
    """The scan below reaches the float and integer-exact host frontends and
    the refresh over a mesh (the JAX package's ``frontend/reference.py`` and
    ``fixedpoint.py`` are NumPy modules the port may not import)."""
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    for name in ("frontend/reference.py", "frontend/fixedpoint.py", "frontend/__init__.py",
                 "data/refresh.py", "parallel/mesh.py"):
        assert f"microwakeword_tpu_torch/{name}" in scanned, name


def test_scan_covers_the_accept_kernel():
    """The scan below reaches accept counting and its kernel's wrapper."""
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    for name in ("evaluate/roc.py", "evaluate/accepts_kernel.py", "evaluate/streaming_eval.py"):
        assert f"microwakeword_tpu_torch/{name}" in scanned, name


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = build_model("mixednet", presets.flagship_config())
    model = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        Model.from_torch(bundle, state)
    with pytest.raises(RuntimeError, match="CUDA"):
        bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        bundle.load(state)
    with pytest.raises(RuntimeError, match="CUDA"):
        plain.streaming_state_init((2,))
    inception = build_model("inception", presets.default_inception_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        inception.init(torch.Generator().manual_seed(0))
    path = str(tmp_path / "model.mww")
    native_runtime.export_model(bundle, state, path)  # NumPy only: no device
    with pytest.raises(RuntimeError, match="CUDA"):
        Model.from_native(path)
    assert Model.from_native(path, device="cpu").predict_spectrogram(
        np.zeros((9, 40), np.float32)).shape == (3,)
    from microwakeword_tpu_torch.export.torch_export import ExportedModel, export_streaming

    exported = str(tmp_path / "model.mwwt")
    export_streaming(bundle, state, exported)  # a host step: no device
    with pytest.raises(RuntimeError, match="CUDA"):
        ExportedModel(exported)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model.from_exported(exported)
    with pytest.raises(RuntimeError, match="CUDA"):  # before it reads the file
        Model.from_tflite(str(tmp_path / "absent.tflite"))
    assert Model.from_exported(exported, device="cpu").predict_spectrogram(
        np.zeros((9, 40), np.float32)).shape == (3,)
    assert Model.from_torch(bundle, state, device="cpu").predict_spectrogram(
        np.zeros((9, 40), np.float32)
    ).shape == (3,)


def test_train_and_run_default_to_cuda(monkeypatch, tmp_path):
    """train() and the CLI's run() raise without a card unless the CPU is
    asked for, before they read any data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = derive_config({"train_dir": str(tmp_path / "run"), "clip_duration_ms": 1500,
                            "window_step_ms": 10, "features": []}, presets.flagship_config())
    bundle = build_model("mixednet", config["model_config"])
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.train(bundle, config, feature_handler=None)
    flags = CLI.build_parser().parse_args(["--training_config", "unused.yaml", "mixednet"])
    assert flags.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        CLI.run(flags, config)
    inc_config = derive_config(dict(config, window_step_ms=20), presets.default_inception_config())
    inc_flags = CLI.build_parser().parse_args(["--training_config", "unused.yaml", "inception"])
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.train(build_model("inception", inc_config["model_config"]), inc_config,
                   feature_handler=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        CLI.run(inc_flags, inc_config)
    flags = CLI.build_parser().parse_args(
        ["--training_config", "unused.yaml", "--device", "cpu", "--train", "0", "mixednet"])
    with pytest.raises(ValueError, match="not trained"):  # the CPU gets past the device check
        CLI.run(flags, config)
    # the sweep CLI, population training and the host producer
    from microwakeword_tpu_torch import sweep
    from microwakeword_tpu_torch.data.host_stream import HostBatchProducer
    from microwakeword_tpu_torch.parallel import population

    sweep_flags = sweep.build_parser().parse_args(["--training_config", "unused.yaml", "mixednet"])
    assert sweep_flags.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run(sweep_flags, config)
    with pytest.raises(RuntimeError, match="CUDA"):
        population.train_population(bundle, None, 2, 1, 4, 204)
    with pytest.raises(RuntimeError, match="CUDA"):
        population.init_population(bundle, [0, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        HostBatchProducer(None, 4, 204)
    assert population.init_population(bundle, [0, 1], "cpu")["Dense_0.weight"].shape[0] == 2


def test_audio_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The dataset build, the raw-audio pack and a clips-type set's
    spectrogram pool raise without a card unless the CPU is asked for."""
    from microwakeword_tpu_torch import build_dataset
    from microwakeword_tpu_torch.audio.io import save_clip
    from microwakeword_tpu_torch.data import sampler
    from microwakeword_tpu_torch.data.store import ClipsFeatureSet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "wav").mkdir()
    save_clip(np.zeros(8000, np.float32), str(tmp_path / "wav" / "a.wav"))
    doc = {"output_dir": str(tmp_path / "out"), "clips": {"input_directory": str(tmp_path / "wav")},
           "splits": {"testing": {"split": None}}}
    with pytest.raises(RuntimeError, match="CUDA"):
        build_dataset.build_feature_dir(doc)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_dataset.main(["--config", str(tmp_path / "unused.yaml")])
    assert build_dataset.build_feature_dir(doc, "cpu", log=lambda *a: None) == {"testing": (1, 48)}
    clips = ClipsFeatureSet({"input_directory": str(tmp_path / "wav")}, {}, {}, True, 1.0, 1.0,
                            "random", pack_pool_size=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        clips.generate_pool()
    with pytest.raises(RuntimeError, match="CUDA"):
        sampler.pack_audio_data([clips])
    assert sampler.pack_audio_data([clips], "cpu").chunks.shape[1] == 160


def test_host_frontends_default_to_cuda(monkeypatch):
    """The host frontends run on the card unless the CPU is asked for."""
    from microwakeword_tpu_torch.frontend import fixedpoint, reference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    audio = np.zeros(800, np.int16)
    frames = np.zeros((1, 480), np.int16)
    for call in (lambda: reference.MicroFrontend(), lambda: fixedpoint.MicroFrontendInt(),
                 lambda: reference.generate_features_for_clip(audio),
                 lambda: fixedpoint.generate_features_for_clip(audio),
                 lambda: reference.frontend_frames(frames, np.zeros(40)),
                 lambda: fixedpoint.frontend_frames_int(frames, np.zeros(40, np.int64)),
                 lambda: fixedpoint.kiss_fftr_int16(np.zeros((1, 512), np.int64))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert reference.generate_features_for_clip(audio, device="cpu").shape == (3, 40)
    assert fixedpoint.generate_features_for_clip(audio, device="cpu").shape == (3, 40)
