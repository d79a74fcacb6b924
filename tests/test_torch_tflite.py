"""The port's TFLite exporter, interpreter runner and ESPHome manifest against
the JAX package's (``export/tflite.py``, ``export/manifest.py``).

- The port's TF streaming graph, built from its state dict, follows the
  port's ``stream_scan`` to 2e-5 (tests/test_export.py's tolerance), for
  MixedNet (residual, stride 3), spatial attention and Inception.
- The port's ``.tflite`` files are byte-equal to the JAX exporter's from the
  same weights (the state dict carried to flax by ``models/convert.py``):
  MixedNet float and int8, streaming and not, Inception float and spatial
  attention; both int8 converters are fed one fixed representative
  generator.
- ``representative_dataset`` yields JAX's chunks from the same training
  windows; ``TFLiteStreamingModel``, ``tflite_model_accuracy`` and
  ``Model.from_tflite`` give JAX's numbers on the same file and store;
  ``write_manifest`` writes JAX's JSON for the same ROC dict.
- The port's ``TFLiteStreamingModel.reset`` starts from zero rings.  The
  JAX runner's (the interpreter's ``reset_all_variables``) keeps the ring
  buffers, so the comparisons run JAX's functions with a runner whose
  reset starts a new interpreter (``_ResetJaxRunner``).
"""

import functools
import json
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from microwakeword_tpu.data.ragged_store import RaggedSpectrogramStore  # noqa: E402
from microwakeword_tpu.data.store import FeatureHandler as JaxFeatureHandler  # noqa: E402
from microwakeword_tpu.export import manifest as JM  # noqa: E402
from microwakeword_tpu.export import tflite as JT  # noqa: E402
from microwakeword_tpu.inference import Model as JaxModel  # noqa: E402
from microwakeword_tpu_torch.data.store import FeatureHandler  # noqa: E402
from microwakeword_tpu_torch.export import manifest as M  # noqa: E402
from microwakeword_tpu_torch.export import tflite as T  # noqa: E402
from microwakeword_tpu_torch.inference import Model  # noqa: E402
from microwakeword_tpu_torch.models import InceptionConfig, MixedNetConfig, build_model  # noqa: E402
from microwakeword_tpu_torch.models import convert  # noqa: E402

torch.set_num_threads(2)

CASES = {  # name: (family, config fields)
    "mixednet": ("mixednet", dict(
        pointwise_filters=(12, 12), repeat_in_block=(1, 1), mixconv_kernel_sizes=((5,), (3, 7)),
        residual_connection=(False, True), first_conv_filters=8, first_conv_kernel_size=5,
        stride=3, spectrogram_length=47)),
    "spatial_attention": ("mixednet", dict(
        pointwise_filters=(8,), repeat_in_block=(1,), mixconv_kernel_sizes=((5,),),
        residual_connection=(False,), first_conv_filters=8, first_conv_kernel_size=3, stride=1,
        pooled=True, spatial_attention=True, spectrogram_length=30)),
    "inception": ("inception", dict(
        cnn1_filters=(8,), cnn1_kernel_sizes=(3,), cnn1_subspectral_groups=(4,),
        cnn2_filters1=(6,), cnn2_filters2=(8,), cnn2_kernel_sizes=(3,),
        cnn2_subspectral_groups=(2,), cnn2_dilation=(2,), spectrogram_length=24)),
}
CONFIG = {"mixednet": MixedNetConfig, "inception": InceptionConfig}


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(port bundle, config, state dict with randomised biases and BatchNorm)."""
    family, kw = CASES[name]
    cfg = CONFIG[family](**kw)
    bundle = build_model(family, cfg)
    model = bundle.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(1)
    state = {}
    for key, value in model.state_dict().items():
        value = value.numpy()
        if key.endswith("var"):
            value = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key.endswith(("mean", "bias", "scale")):
            value = value + rng.normal(0.0, 0.1, value.shape).astype(np.float32)
        state[key] = value
    return bundle, cfg, state


def _jax_module(name: str, streaming: bool):
    bundle, cfg, state = _case(name)
    variables = convert.state_to_flax(state)
    return JT.build_tf_streaming(bundle.name, cfg, variables["params"], variables["batch_stats"],
                                 streaming=streaming)


def _rep_gen(steps: int, seed: int = 5):
    """One fixed calibration generator: ``steps``-frame chunks pinned to the
    frontend range."""
    def gen():
        rng = np.random.default_rng(seed)
        for _ in range(60):
            chunk = rng.uniform(0, 26, (1, steps, 40)).astype(np.float32)
            chunk[0, 0, 0] = 0.0
            chunk[0, -1, -1] = 26.0
            yield [chunk]
    return gen


def _tf_stream(module, x: np.ndarray, stride: int) -> np.ndarray:
    return np.asarray([float(np.asarray(module.forward(tf.convert_to_tensor(x[:, i : i + stride])))
                             .reshape(-1)[0]) for i in range(0, x.shape[1], stride)])


@pytest.mark.parametrize("name", list(CASES))
def test_tf_graph_matches_stream_scan(name):
    bundle, cfg, state = _case(name)
    module = T.build_tf_streaming(bundle.name, cfg, state)
    t = 2 * cfg.spectrogram_length // cfg.stride * cfg.stride
    x = np.random.default_rng(0).uniform(0, 26, (1, t, 40)).astype(np.float32)
    want = bundle.stream_scan(bundle.load(state, "cpu"), torch.from_numpy(x)).reshape(-1).numpy()
    np.testing.assert_allclose(_tf_stream(module, x, cfg.stride), want, atol=2e-5)


def test_tf_nonstreaming_graph_matches_forward():
    bundle, cfg, state = _case("mixednet")
    module = T.build_tf_streaming(bundle.name, cfg, state, streaming=False)
    x = np.random.default_rng(1).uniform(0, 26, (1, cfg.spectrogram_length, 40)).astype(np.float32)
    want = float(bundle.forward(bundle.load(state, "cpu"), torch.from_numpy(x)))
    got = float(np.asarray(module.forward(tf.convert_to_tensor(x))).reshape(-1)[0])
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("name,quantize,streaming", [
    ("mixednet", False, True), ("mixednet", True, True), ("mixednet", False, False),
    ("mixednet", True, False), ("inception", False, True), ("spatial_attention", False, True),
])
def test_tflite_bytes_match_jax(tmp_path, name, quantize, streaming):
    bundle, cfg, state = _case(name)
    steps = cfg.stride if streaming else cfg.spectrogram_length
    rep = _rep_gen(steps) if quantize else None
    got = T.convert_to_tflite(T.build_tf_streaming(bundle.name, cfg, state, streaming),
                              str(tmp_path / "port.tflite"), quantize, rep)
    want = JT.convert_to_tflite(_jax_module(name, streaming), str(tmp_path / "jax.tflite"),
                                quantize, rep)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_spatial_attention_without_pooling_raises():
    bundle, cfg, state = _case("spatial_attention")
    flat = MixedNetConfig(**dict(CASES["spatial_attention"][1], pooled=False))
    with pytest.raises(ValueError, match="pooled=True"):
        T.build_tf_streaming("mixednet", flat, state)


def test_missing_tensorflow_raises(monkeypatch):
    bundle, cfg, state = _case("mixednet")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="TFLite export needs tensorflow"):
        T.build_tf_streaming(bundle.name, cfg, state)


class _ResetJaxRunner(JT.TFLiteStreamingModel):
    """The JAX runner with a reset that starts a new interpreter."""

    def __init__(self, path, stride=1):
        self._args = (path, stride)
        super().__init__(path, stride)

    def reset(self):
        super().__init__(*self._args)


@pytest.fixture
def jax_reset(monkeypatch):
    monkeypatch.setattr(JT, "TFLiteStreamingModel", _ResetJaxRunner)


class _FixedHandler:
    """A feature handler whose training draw is a fixed set of windows."""

    def __init__(self, x):
        self.x = x

    def get_data(self, mode, batch_size, features_length, truncation_strategy):
        assert mode == "training" and truncation_strategy == "default"
        return self.x[:batch_size, :features_length], None, None


@pytest.mark.parametrize("streaming", [True, False])
def test_representative_dataset_matches_jax(streaming):
    x = np.random.default_rng(2).uniform(0, 26, (6, 20, 40)).astype(np.float32)
    config = {"stride": 3, "spectrogram_length": 20}
    want = list(JT.representative_dataset(_FixedHandler(x), config, 5, streaming)())
    got = list(T.representative_dataset(_FixedHandler(x), config, 5, streaming)())
    assert len(got) == len(want) == 5 * (6 if streaming else 1)
    for (a,), (b,) in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        assert a[0, 0, 0] == 0.0 and a[0, -1, -1] == 26.0


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """(config, the int8 streaming .tflite of the 'mixednet' case): a testing
    and an ambient store of uint16 spectrograms."""
    root = tmp_path_factory.mktemp("tflite_store")
    rng = np.random.default_rng(3)
    for mode, n, lo, hi in (("testing", 4, 50, 80), ("testing_ambient", 2, 200, 300)):
        (root / "pos" / mode).mkdir(parents=True)
        RaggedSpectrogramStore.create(
            str(root / "pos" / mode / "w_mmap"),
            [rng.uniform(0, 660, (int(rng.integers(lo, hi)), 40)).astype(np.uint16)
             for _ in range(n)])
    bundle, cfg, state = _case("mixednet")
    config = {"stride": cfg.stride, "window_step_ms": 10,
              "spectrogram_length": cfg.spectrogram_length, "spectrogram_length_final_layer": 5,
              "batch_size": 8, "features": [
                  {"features_dir": str(root / "pos"), "truth": True, "sampling_weight": 1.0,
                   "penalty_weight": 1.0, "truncation_strategy": "truncate_start",
                   "type": "mmap"}]}
    path = T.convert_to_tflite(T.build_tf_streaming(bundle.name, cfg, state),
                               str(root / "stream_q.tflite"), True, _rep_gen(cfg.stride))
    return config, path


def test_reset_starts_from_zero_rings(store):
    _, path = store
    x = np.random.default_rng(7).uniform(0, 26, (30, 40)).astype(np.float32)
    runner = T.TFLiteStreamingModel(path, stride=3)
    first = runner.predict_spectrogram(x)
    runner.reset()
    np.testing.assert_array_equal(runner.predict_spectrogram(x), first)


def test_runner_and_accuracy_match_jax(store, tmp_path, jax_reset):
    config, path = store
    x = np.random.default_rng(4).uniform(0, 26, (60, 40)).astype(np.float32)
    got = T.TFLiteStreamingModel(path, stride=3).predict_spectrogram(x)
    want = _ResetJaxRunner(path, stride=3).predict_spectrogram(x)
    assert got.shape == (20,)
    np.testing.assert_array_equal(got, want)
    for data_set in ("testing", "testing_ambient"):
        got = T.tflite_model_accuracy(path, FeatureHandler(config), config, data_set,
                                      folder=str(tmp_path / "port"))
        want = JT.tflite_model_accuracy(path, JaxFeatureHandler(config), config, data_set,
                                        folder=str(tmp_path / "jax"))
        assert got.keys() == want.keys()
        for key, value in want.items():
            assert got[key] == value or (np.isnan(got[key]) and np.isnan(value)), key
    for name in ("tflite_model_accuracy.txt",):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_model_from_tflite_matches_jax(store, jax_reset):
    _, path = store
    x = np.random.default_rng(5).uniform(0, 26, (61, 40)).astype(np.float32)
    model, jax_model = Model.from_tflite(path, stride=3, device="cpu"), JaxModel.from_tflite(path, 3)
    for _ in range(2):  # the second call after a reset
        np.testing.assert_array_equal(model.predict_spectrogram(x), jax_model.predict_spectrogram(x))
    pcm = np.random.default_rng(6).integers(-8000, 8000, 8000).astype(np.int16)
    from microwakeword_tpu_torch.frontend import frontend_batch

    feats = frontend_batch(torch.from_numpy(pcm)[None], step_ms=10)[0].numpy()
    np.testing.assert_array_equal(model.predict_clip(pcm),
                                  T.TFLiteStreamingModel(path, 3).predict_spectrogram(feats))


def test_manifest_matches_jax(store, tmp_path):
    _, path = store
    for faph in (np.linspace(40.0, 0.0, 101), np.zeros(101), np.full(101, 9.9)):
        for target in (0.5, 2.0):
            assert (M.recommended_cutoff({"faph_at_cutoffs": faph}, target)
                    == JM.recommended_cutoff({"faph_at_cutoffs": faph}, target))
    assert M.estimate_tensor_arena_size(path) == JM.estimate_tensor_arena_size(path)
    roc = {"faph_at_cutoffs": np.linspace(3.0, 0.0, 101)}
    kw = dict(wake_word="okay nabu", sliding_window_size=5, feature_step_size=10)
    got = M.write_manifest(path, probability_cutoff=M.recommended_cutoff(roc), **kw,
                           manifest_path=str(tmp_path / "port.json"))
    want = JM.write_manifest(path, probability_cutoff=JM.recommended_cutoff(roc), **kw,
                             manifest_path=str(tmp_path / "jax.json"))
    with open(got) as f, open(want) as g:
        text = f.read()
        assert text == g.read()
    assert json.loads(text)["micro"]["minimum_esphome_version"] == JM.MINIMUM_ESPHOME_VERSION
