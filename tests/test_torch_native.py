"""The port's bindings of ``native/src/mww_native.cc`` (``native.py``) against
the JAX package's (``microwakeword_tpu.native``, its library on), on the
inputs of tests/test_native.py.

- The port builds its own library from the source with ``g++`` into
  ``_build/``; the gather, the WAV decoder and writer, the resampler and the
  VAD give the JAX binding's arrays bit for bit, and hold to the NumPy and
  SciPy versions with tests/test_native.py's tolerances (the resampler to
  scipy 2e-4, the VAD to NumPy 1e-6, the gather exactly);
- ``audio/io.load_audio``, ``audio/vad.remove_silence`` and the store's
  ``gather_mode`` give the JAX package's defaults; a WAV the decoder does not
  read goes to scipy in both;
- the build is safe when several builders race, and no process of the port
  maps the committed ``native/libmwwnative.so``.
"""

import ctypes
import os
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile
from scipy.signal import resample_poly

from microwakeword_tpu import native as J
from microwakeword_tpu.audio import io as JIO
from microwakeword_tpu.audio import vad as JV
from microwakeword_tpu_torch import _build
from microwakeword_tpu_torch import native as P
from microwakeword_tpu_torch.audio import io as IO
from microwakeword_tpu_torch.audio import vad as V
from microwakeword_tpu_torch.data import store

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not J.available(), reason="the JAX package's native library")


def _ragged(seed, lengths):
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return rng, offsets, rng.integers(0, 660, (offsets[-1], 40)).astype(np.uint16)


def test_gather_windows_matches_jax_and_plain():
    _, offsets, data = _ragged(0, [7, 30, 12, 55])
    clip_idx = np.array([0, 1, 2, 3, 1], np.int32)
    starts = np.array([0, -3, 5, 40, 10], np.int32)  # left pad / mid / overrun
    got = P.gather_windows(data, offsets, clip_idx, starts, 20)
    np.testing.assert_array_equal(got, J.gather_windows(data, offsets, clip_idx, starts, 20))
    np.testing.assert_array_equal(got, store.gather_windows(data, offsets, clip_idx, starts, 20))


def test_gather_windows_threaded_matches_serial():
    rng, offsets, data = _ragged(1, np.random.default_rng(1).integers(10, 60, 100))
    clip_idx = rng.integers(0, 100, 512).astype(np.int32)
    starts = rng.integers(-5, 50, 512).astype(np.int32)
    serial = P.gather_windows(data, offsets, clip_idx, starts, 30, n_threads=1)
    np.testing.assert_array_equal(P.gather_windows(data, offsets, clip_idx, starts, 30, n_threads=8),
                                  serial)
    np.testing.assert_array_equal(serial, J.gather_windows(data, offsets, clip_idx, starts, 30))


@pytest.mark.parametrize("dtype,tol", [("int16", 1e-4), ("int32", 1e-6), ("float32", 1e-7)])
def test_wav_read_matches_jax(tmp_path, dtype, tol):
    x = np.random.default_rng(2).uniform(-0.8, 0.8, 4000).astype(np.float32)
    path = str(tmp_path / f"t_{dtype}.wav")
    scale = {"int16": 32767, "int32": 2147483647, "float32": 1}[dtype]
    wavfile.write(path, 16000, (x * scale).astype(dtype))
    got, rate = P.wav_read_mono_f32(path)
    want, want_rate = J.wav_read_mono_f32(path)
    assert rate == want_rate == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, x, atol=tol)


def test_wav_stereo_monomix_matches_jax(tmp_path):
    stereo = np.random.default_rng(3).uniform(-0.5, 0.5, (1000, 2)).astype(np.float32)
    path = str(tmp_path / "stereo.wav")
    wavfile.write(path, 22050, (stereo * 32767).astype(np.int16))
    got, rate = P.wav_read_mono_f32(path)
    assert rate == 22050
    np.testing.assert_array_equal(got, J.wav_read_mono_f32(path)[0])
    want = (stereo * 32767).astype(np.int16).astype(np.float32).mean(1) / 32768.0
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_wav_write_matches_jax(tmp_path):
    samples = np.random.default_rng(4).integers(-30000, 30000, 2000).astype(np.int16)
    P.wav_write_16k_i16(str(tmp_path / "port.wav"), samples)
    J.wav_write_16k_i16(str(tmp_path / "jax.wav"), samples)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    rate, back = wavfile.read(str(tmp_path / "port.wav"))
    assert rate == 16000
    np.testing.assert_array_equal(back, samples)


@pytest.mark.parametrize("up,down", [(2, 1), (1, 2), (160, 441), (320, 147)])
def test_resample_matches_jax_and_scipy(up, down):
    x = np.random.default_rng(5).uniform(-1, 1, 4410).astype(np.float32)
    got = P.resample_poly(x, up, down)
    np.testing.assert_array_equal(got, J.resample_poly(x, up, down))
    want = resample_poly(x.astype(np.float64), up, down)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=2e-4)


def _vad_input():
    rng = np.random.default_rng(6)
    return np.concatenate([rng.uniform(-0.01, 0.01, 8000), rng.uniform(-0.8, 0.8, 8000),
                           rng.uniform(-0.005, 0.005, 8000)]).astype(np.float32)


def test_remove_silence_matches_jax_and_numpy():
    audio = _vad_input()
    got = P.remove_silence_f32(audio, step=480, min_start=2000, threshold_ratio=0.1)
    np.testing.assert_array_equal(
        got, J.remove_silence_f32(audio, step=480, min_start=2000, threshold_ratio=0.1))
    want = V.remove_silence_plain(audio)
    assert len(got) == len(want) < len(audio)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
def test_vad_default_matches_jax(dtype):
    audio = _vad_input()
    audio = (audio * 32767).astype(np.int16) if dtype == np.int16 else audio.astype(dtype)
    got = V.remove_silence(audio)
    want = JV.remove_silence(audio)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def _rifx(path, rate, samples):
    """A big-endian (RIFX) 16-bit mono WAV: scipy reads it, the native
    decoder does not."""
    data = samples.astype(">i2").tobytes()
    fmt = struct.pack(">HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    body = b"WAVE" + b"fmt " + struct.pack(">I", 16) + fmt + b"data" + struct.pack(">I", len(data))
    Path(path).write_bytes(b"RIFX" + struct.pack(">I", len(body) + len(data)) + body + data)


@pytest.mark.parametrize("kind", ["int16 16k", "int16 44.1k", "stereo int32 22.05k", "uint8 8k",
                                  "rifx 48k"])
def test_load_audio_matches_jax_default(tmp_path, kind):
    rng = np.random.default_rng(7)
    path = str(tmp_path / "a.wav")
    if kind == "int16 16k":
        wavfile.write(path, 16000, (8000 * rng.standard_normal(4000)).astype(np.int16))
    elif kind == "int16 44.1k":
        wavfile.write(path, 44100, (8000 * rng.standard_normal(8820)).astype(np.int16))
    elif kind == "stereo int32 22.05k":
        wavfile.write(path, 22050, (1e8 * rng.standard_normal((3000, 2))).astype(np.int32))
    elif kind == "uint8 8k":
        wavfile.write(path, 8000, rng.integers(0, 256, 5000).astype(np.uint8))
    else:
        _rifx(path, 48000, (8000 * rng.standard_normal(4800)).astype(np.int16))
        with pytest.raises(ValueError):
            P.wav_read_mono_f32(path)
    got = IO.load_audio(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, JIO.load_audio(path))
    np.testing.assert_allclose(got, IO.load_audio_plain(path), atol=2e-4)


def test_float64_wav_goes_to_scipy(tmp_path):
    """The decoder takes a float64 header and writes zeros; the port's
    binding refuses it, so load_audio reads it with scipy."""
    x = np.random.default_rng(8).uniform(-0.5, 0.5, 3000)
    path = str(tmp_path / "f64.wav")
    wavfile.write(path, 16000, x)
    with pytest.raises(ValueError, match="64-bit float"):
        P.wav_read_mono_f32(path)
    np.testing.assert_array_equal(IO.load_audio(path), x.astype(np.float32))


def test_store_gather_mode_matches_feature_generator(tmp_path):
    from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore

    rng = np.random.default_rng(9)
    specs = [rng.integers(0, 660, (n, 40)).astype(np.uint16) for n in [12, 35, 60, 8, 200]]
    for mode in ("validation", "validation_ambient"):
        (tmp_path / mode).mkdir()
        RaggedSpectrogramStore.create(str(tmp_path / mode / "x_mmap"), specs)
    for strategy, mode in [("truncate_start", "validation"), ("truncate_end", "validation"),
                           ("fixed_right_cutoff", "validation"), ("split", "validation_ambient")]:
        fs = store.MmapFeatureSet(str(tmp_path), True, 1.0, 1.0, strategy, stride=3, step_ms=10,
                                  fixed_right_cutoffs=[0, 2])
        want = np.stack(list(fs.feature_generator(mode, 25, strategy)))
        got = fs.gather_mode(mode, 25, strategy)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_native_build_is_safe_in_parallel(tmp_path, monkeypatch):
    """Builders racing on an empty build directory each compile to a
    temporary file and rename it into place: all return the same path, no
    temporary file is left, and the library loads."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    paths, errors = [], []

    def build():
        try:
            paths.append(_build.build_native()[0])
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
    assert ctypes.CDLL(str(paths[0])).mww_resample_poly is not None


_MAPS = """
import numpy as np, sys
from microwakeword_tpu_torch import native
from microwakeword_tpu_torch.audio import io, vad
from microwakeword_tpu_torch.export import native_runtime
io.save_clip(np.zeros(1600, np.float32), sys.argv[1])
io.load_audio(sys.argv[1])
vad.remove_silence(np.zeros(9000, np.float32))
native.runtime_lib()
print("\\n".join(line.split()[-1] for line in open("/proc/self/maps") if ".so" in line))
"""


@pytest.mark.skipif(not os.path.exists("/proc/self/maps"), reason="needs /proc")
def test_the_port_never_maps_the_prebuilt_library(tmp_path):
    out = subprocess.run([sys.executable, "-c", _MAPS, str(tmp_path / "z.wav")], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    mapped = set(out.stdout.split())
    assert not [m for m in mapped if m.endswith("libmwwnative.so")]
    assert str(_build.native_library_path()) in mapped
    assert str(_build.runtime_library_path()) in mapped
