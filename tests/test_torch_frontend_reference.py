"""The host frontends (``frontend/reference.py``, ``frontend/fixedpoint.py``)
against the JAX package's NumPy modules, on the CPU:

- the integer-exact frontend equals JAX's ``fixedpoint`` bit for bit on the
  golden clips of tests/golden/frontend.npz and on seeded clips, at 10 and
  20 ms, and meets tests/test_frontend.py's tolerances against the C op's
  golden features; its FFT, PCAN gain and shrink equal JAX's;
- the float frontend equals JAX's ``reference`` under the Q6 gate, every
  cell equal;
- both are stateful: a clip fed a window at a time, or in two chunks, equals
  the whole clip; silence gives zero features;
- ``generate_features_for_clip`` truncates float PCM by the reference's rule.
"""

import numpy as np
import pytest
import torch

from microwakeword_tpu.frontend import fixedpoint as JF
from microwakeword_tpu.frontend import reference as JR
from microwakeword_tpu_torch import frontend as port_frontend
from microwakeword_tpu_torch.frontend import fixedpoint as F
from microwakeword_tpu_torch.frontend import gate
from microwakeword_tpu_torch.frontend import reference as R

torch.set_num_threads(2)

GOLDEN = "tests/golden/frontend.npz"
NAMES = ["impulses", "modulated", "noise_2000", "noise_50", "silence", "speechish", "tone_1k",
         "tone_250", "tone_pulsed"]


@pytest.fixture(scope="module")
def golden(request):
    return np.load(request.config.rootpath / GOLDEN)


def _seeded_clip(seed: int) -> np.ndarray:
    """Noise at a seeded level with a gated tone: 1.2 s of int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(19200) / 16000.0
    x = rng.normal(0, rng.uniform(50, 3000), t.size)
    x += rng.uniform(2000, 20000) * np.sin(2 * np.pi * rng.uniform(200, 6000) * t) * (
        np.sin(2 * np.pi * 6 * t) > 0)
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def _clips(golden):
    return [(f"golden {n}", golden[f"audio_{n}"]) for n in NAMES] + [
        (f"seed {s}", _seeded_clip(s)) for s in range(3)]


def test_exports_match_jax():
    """``frontend`` exports the JAX package's names."""
    for name in ("MicroFrontend", "generate_features_for_clip", "FEATURE_SCALE", "NUM_CHANNELS",
                 "SAMPLE_RATE", "WINDOW_SAMPLES"):
        assert hasattr(port_frontend, name), name
    assert port_frontend.MicroFrontend is R.MicroFrontend


@pytest.mark.parametrize("step_ms", [10, 20])
def test_fixedpoint_bit_exact_with_jax(golden, step_ms):
    for label, audio in _clips(golden):
        want = JF.MicroFrontendInt(step_ms).process_clip(audio)
        got = F.MicroFrontendInt(step_ms, device="cpu").process_clip(audio)
        assert got.dtype == torch.uint16 and got.shape == want.shape, label
        np.testing.assert_array_equal(got.numpy(), want, err_msg=label)


@pytest.mark.parametrize("step_ms", [10, 20])
def test_fixedpoint_matches_c_frontend(golden, step_ms):
    """tests/test_frontend.py:118-131's tolerances against the C op."""
    for name in NAMES:
        want = golden[f"feat{step_ms}_{name}"].astype(np.int64)
        got = F.MicroFrontendInt(step_ms, device="cpu").process_clip(golden[f"audio_{name}"])
        got = got.numpy().astype(np.int64)
        n = min(len(want), len(got))
        assert n > 50
        d = np.abs(got[:n] - want[:n])
        assert (d == 0).mean() > 0.97, name
        mutual = (want[:n] > 200) & (got[:n] > 200)
        if mutual.any():
            assert d[mutual].mean() < 1.0, name
        assert d.mean() < 2.0, name


@pytest.mark.parametrize("step_ms", [10, 20])
def test_reference_matches_jax(golden, step_ms):
    for label, audio in _clips(golden):
        want = JR.MicroFrontend(step_ms).process_clip(audio)
        got = R.MicroFrontend(step_ms, device="cpu").process_clip(audio)
        assert got.dtype == torch.uint16 and got.shape == want.shape, label
        gate.assert_q6_gate(got.numpy() * R.FEATURE_SCALE, want * JR.FEATURE_SCALE, exact=True)


def test_fixedpoint_pieces_match_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(-32768, 32768, (6, 512))
    x[0] = 0
    want_r, want_i = JF.kiss_fftr_int16(x)
    got_r, got_i = F.kiss_fftr_int16(x, device="cpu")
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    xs = np.unique(np.concatenate([np.arange(70), np.round(np.logspace(0, 9.5, 400))])).astype(
        np.int64)
    np.testing.assert_array_equal(F.wide_dynamic_function(torch.from_numpy(xs)).numpy(),
                                  JF.wide_dynamic_function(xs))
    snr = np.arange(0, 20000, 7, dtype=np.int64)
    np.testing.assert_array_equal(F.pcan_shrink(torch.from_numpy(snr)).numpy(),
                                  JF.pcan_shrink(snr))
    frames = rng.integers(-20000, 20000, (5, 480))
    np.testing.assert_array_equal(
        F.scaled_filterbank_int(torch.from_numpy(frames)).numpy(), JF.scaled_filterbank_int(frames))


@pytest.mark.parametrize("module", [R, F], ids=["reference", "fixedpoint"])
@pytest.mark.parametrize("step_ms", [10, 20])
def test_chunked_equals_whole(golden, module, step_ms):
    """The noise estimate carries across calls: window by window, and two
    chunks split on a frame boundary, equal the whole clip; reset starts
    over."""
    cls = module.MicroFrontend if module is R else module.MicroFrontendInt
    audio = golden["audio_modulated"]
    whole = cls(step_ms, device="cpu").process_clip(audio)
    fe = cls(step_ms, device="cpu")
    frames = JR.frame_audio(audio, step_ms)
    windows = torch.stack([fe.process_window(frames[t]) for t in range(len(frames))])
    assert torch.equal(windows, whole)
    hop, m = 16 * step_ms, 37
    fe.reset()
    first = fe.process_clip(audio[: m * hop + 480 - hop])
    second = fe.process_clip(audio[m * hop :])
    assert len(first) == m and torch.equal(torch.cat([first, second]), whole)
    assert len(cls(step_ms, device="cpu").process_clip(audio[:400])) == 0


@pytest.mark.parametrize("module", [R, F], ids=["reference", "fixedpoint"])
def test_silence_is_zero(golden, module):
    feats = module.generate_features_for_clip(golden["audio_silence"], 10, device="cpu")
    assert feats.dtype == torch.float32 and feats.shape == (198, 40)
    assert not feats.any()
    np.testing.assert_array_equal(feats.numpy(), golden["feat10_silence"].astype(np.float32))


@pytest.mark.parametrize("module,jax_module", [(R, JR), (F, JF)], ids=["reference", "fixedpoint"])
def test_float_pcm_truncates_as_jax(module, jax_module):
    """Float PCM is truncated toward zero after the 32768 scale, as the JAX
    per-clip functions do (rounding would give other features)."""
    rng = np.random.default_rng(6)
    audio = (rng.uniform(-0.3, 0.3, 8000) + 0.49 / 32768).astype(np.float32)
    want = jax_module.generate_features_for_clip(audio, 10)
    got = module.generate_features_for_clip(audio, 10, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    rounded = module.generate_features_for_clip(
        np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16), 10, device="cpu")
    assert not torch.equal(rounded, got)
