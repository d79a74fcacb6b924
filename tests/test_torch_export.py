"""The port's ``.mww`` exporters and its binding of the C++ streaming runtime.

- The port's exporters write the same bytes as the JAX package's from the
  same weights (the port's state dict, carried to flax by
  ``models/convert.py``): float for MixedNet (residual, stride 3, pooled,
  spatial attention) and Inception, int8 on the same calibration set for
  each that has an int8 form; the int8 exporter refuses what the JAX one
  refuses.
- The runtime, built from ``native/src/mww_runtime.cc`` by ``g++`` into
  ``_build/``, runs the port's ``.mww`` to the JAX test's tolerance of the
  port's ``stream_scan`` (rtol 2e-4, atol 2e-5), ``reset()`` repeats it
  exactly, and the int8 file stays within 0.08 of the float one
  (tests/test_native_quant.py's envelope).
- ``Model.from_native`` serves the file; the build is safe when several
  processes build at once.
"""

import ctypes
import functools
import os
import threading

import numpy as np
import pytest
import torch

from microwakeword_tpu.export.native_runtime import export_model as jax_export_model
from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.inception import InceptionConfig as JaxInceptionConfig
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxMixedNetConfig
from microwakeword_tpu_torch import _build
from microwakeword_tpu_torch.export import native_quant
from microwakeword_tpu_torch.export.native_runtime import export_model
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import InceptionConfig, MixedNetConfig, build_model, convert
from microwakeword_tpu_torch.native import StreamingRuntime

torch.set_num_threads(2)

CONFIGS = {  # name: (family, config fields, has an int8 form)
    "residual_stride2": ("mixednet", dict(
        pointwise_filters=(8, 10), repeat_in_block=(2, 1), mixconv_kernel_sizes=((3,), (5, 7)),
        residual_connection=(True, False), first_conv_filters=8, first_conv_kernel_size=3,
        stride=2, spectrogram_length=40), True),
    "flagship_like": ("mixednet", dict(
        pointwise_filters=(16, 16), repeat_in_block=(1, 1), mixconv_kernel_sizes=((5,), (7, 11)),
        residual_connection=(False, True), first_conv_filters=16, first_conv_kernel_size=5,
        stride=3, spectrogram_length=52), True),
    "pooled_max": ("mixednet", dict(
        pointwise_filters=(8,), repeat_in_block=(1,), mixconv_kernel_sizes=((5,),),
        residual_connection=(False,), first_conv_filters=8, first_conv_kernel_size=3, stride=1,
        pooled=True, max_pool=True, spectrogram_length=30), True),
    "spatial_attention": ("mixednet", dict(
        pointwise_filters=(8,), repeat_in_block=(1,), mixconv_kernel_sizes=((5,),),
        residual_connection=(False,), first_conv_filters=8, first_conv_kernel_size=3, stride=1,
        pooled=True, spatial_attention=True, spectrogram_length=30), False),
    "inception": ("inception", dict(
        cnn1_filters=(8,), cnn1_kernel_sizes=(3,), cnn1_subspectral_groups=(4,),
        cnn2_filters1=(6, 8), cnn2_filters2=(8, 12), cnn2_kernel_sizes=(3, 5),
        cnn2_subspectral_groups=(1, 2), cnn2_dilation=(1, 2), spectrogram_length=60), True),
}
PORT_CONFIG = {"mixednet": MixedNetConfig, "inception": InceptionConfig}
JAX_CONFIG = {"mixednet": JaxMixedNetConfig, "inception": JaxInceptionConfig}


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(port bundle, state dict with randomised biases and BN, calibration
    spectrograms [32, T, 40])."""
    family, kw, _ = CONFIGS[name]
    tb = build_model(family, PORT_CONFIG[family](**kw))
    model = tb.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(1)
    state = {}
    for key, value in model.state_dict().items():
        value = value.numpy()
        if key.endswith("var"):
            value = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key.endswith(("mean", "bias", "scale")):
            value = value + rng.normal(0.0, 0.1, value.shape).astype(np.float32)
        state[key] = value
    calib = rng.uniform(0.0, 26.0, (32, kw["spectrogram_length"], 40))
    return tb, state, calib


def _both(name: str, quantize: bool, tmp_path):
    """The bytes of the port's and the JAX package's export of one state."""
    family, kw, _ = CONFIGS[name]
    tb, state, calib = _case(name)
    jb = jax_build_model(family, JAX_CONFIG[family](**kw))
    ours, theirs = tmp_path / "port.mww", tmp_path / "jax.mww"
    export_model(tb, state, str(ours), quantize=quantize, calibration=calib)
    jax_export_model(jb, convert.state_to_flax(state), str(theirs), quantize=quantize,
                     calibration=calib)
    return ours.read_bytes(), theirs.read_bytes()


def _first_difference(a: bytes, b: bytes) -> str:
    n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return f"lengths {len(a)} / {len(b)}; first differing byte at offset {n}"


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_mww_bytes_match_jax_exporter(name, quantize, tmp_path):
    if quantize and not CONFIGS[name][2]:
        tb, state, calib = _case(name)
        for exporter in (lambda p: export_model(tb, state, p, quantize=True, calibration=calib),
                         lambda p: jax_export_model(
                             jax_build_model("mixednet", JaxMixedNetConfig(**CONFIGS[name][1])),
                             convert.state_to_flax(state), p, quantize=True)):
            with pytest.raises(ValueError, match="spatial_attention"):
                exporter(str(tmp_path / "x.mww"))
        return
    ours, theirs = _both(name, quantize, tmp_path)
    assert ours == theirs, _first_difference(ours, theirs)


def test_int8_refuses_mixconv_bias(tmp_path):
    kw = dict(CONFIGS["flagship_like"][1], mixconv_bias=True)
    tb = build_model("mixednet", MixedNetConfig(**kw))
    state = tb.init(torch.Generator().manual_seed(0), device="cpu").state_dict()
    with pytest.raises(ValueError, match="mixconv_bias"):
        export_model(tb, state, str(tmp_path / "x.mww"), quantize=True)


def test_int8_self_check_raises_value_error(tmp_path, monkeypatch):
    """A folded simulator that strays from the live model past 5e-3 raises
    ValueError, which the CLI's guard catches."""
    tb, state, calib = _case("inception")
    assert native_quant.self_check(tb, state, native_quant.build_stages_inception(tb, state),
                                   calib[:8]) < 1e-4
    monkeypatch.setattr(native_quant, "self_check", lambda *a: 6e-3)
    with pytest.raises(ValueError, match="deviates from the live model"):
        export_model(tb, state, str(tmp_path / "x.mww"), quantize=True, calibration=calib)


@pytest.mark.parametrize("name", ["flagship_like", "inception", "spatial_attention"])
def test_runtime_runs_port_mww_like_stream_scan(name, tmp_path):
    tb, state, calib = _case(name)
    path = str(tmp_path / "model.mww")
    export_model(tb, state, path)
    rt = StreamingRuntime(path)
    assert rt.stride == tb.stride and rt.input_features == 40
    spec = np.random.default_rng(2).uniform(0, 26, (40 * tb.stride + 5, 40)).astype(np.float32)
    got = rt.predict_spectrogram(spec)
    model = tb.load(state, device="cpu")
    want = tb.stream_scan(model, torch.from_numpy(spec)[None]).reshape(-1).numpy()
    assert got.shape == want.shape == (spec.shape[0] // tb.stride,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    rt.reset()
    np.testing.assert_array_equal(rt.predict_spectrogram(spec), got)


@pytest.mark.parametrize("name", ["flagship_like", "inception"])
def test_int8_runtime_tracks_float(name, tmp_path):
    tb, state, calib = _case(name)
    f32, i8 = str(tmp_path / "f.mww"), str(tmp_path / "q.mww")
    export_model(tb, state, f32)
    export_model(tb, state, i8, quantize=True, calibration=calib)
    assert os.path.getsize(i8) < 0.6 * os.path.getsize(f32)
    spec = np.random.default_rng(3).uniform(0, 26, (tb.spectrogram_length * 3, 40)).astype(
        np.float32)
    rt_f, rt_q = StreamingRuntime(f32), StreamingRuntime(i8)
    pf, pq = rt_f.predict_spectrogram(spec), rt_q.predict_spectrogram(spec)
    assert np.abs(pq - pf).max() < 0.08
    rt_q.reset()
    np.testing.assert_array_equal(pq, rt_q.predict_spectrogram(spec))


def test_model_from_native(tmp_path):
    """The runtime behind ``Model``: the spectrogram path and the clip path
    (the port's frontend, here on the CPU) agree with ``from_torch``."""
    tb, state, _ = _case("inception")
    path = str(tmp_path / "model.mww")
    export_model(tb, state, path)
    native = Model.from_native(path, step_ms=20, device="cpu")
    torch_model = Model.from_torch(tb, state, device="cpu")
    assert native.stride == 1 and native.module is None
    spec = np.random.default_rng(4).uniform(0, 26, (80, 40)).astype(np.float32)
    np.testing.assert_allclose(native.predict_spectrogram(spec),
                               torch_model.predict_spectrogram(spec), rtol=2e-4, atol=2e-5)
    audio = (np.random.default_rng(5).standard_normal(16000) * 3000).astype(np.int16)
    got = native.predict_clip(audio, step_ms=20)
    assert got.shape == (49,)
    np.testing.assert_allclose(got, torch_model.predict_clip(audio, step_ms=20), rtol=2e-4,
                               atol=2e-5)


def test_runtime_frontend_bindings(tmp_path):
    """The runtime's own PCM path: ``predict_clip`` is its frontend
    (``process_features``) followed by the streaming model, and the
    features are the micro-frontend's (the port's plain version, within the
    float frontend's noise floor of its integer reference)."""
    from microwakeword_tpu_torch.frontend import plain

    tb, state, _ = _case("inception")
    path = str(tmp_path / "model.mww")
    export_model(tb, state, path)
    rt = StreamingRuntime(path, step_ms=20)
    t = np.arange(32000) / 16000
    pcm = (8000 * np.sin(2 * np.pi * 900 * t) * (np.sin(2 * np.pi * 3 * t) > 0)
           + np.random.default_rng(6).standard_normal(32000) * 300).astype(np.int16)
    feats = rt.process_features(pcm)
    assert feats.shape == (99, 40)
    want = plain.frontend_batch(torch.from_numpy(pcm)[None], step_ms=20)[0].numpy()
    assert np.abs(feats - want).mean() < 0.15
    rt.reset()
    probs = rt.predict_clip(pcm)
    rt.reset()
    np.testing.assert_array_equal(probs, rt.predict_spectrogram(feats))


def test_runtime_build_is_safe_in_parallel(tmp_path, monkeypatch):
    """Builders racing on an empty build directory (threads here, processes
    in the xdist workers) each compile to a
    temporary file and rename it into place: all return the same path,
    no temporary file is left, and the library loads."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    paths, errors = [], []

    def build():
        try:
            paths.append(_build.build_runtime()[0])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path / "_build"
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [paths[0].name]
    assert ctypes.CDLL(str(paths[0])).mww_model_load is not None
