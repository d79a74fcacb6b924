"""The port's micro-frontend against the JAX package's.

The same int16/float PCM, made from a numpy seed, goes through
``microwakeword_tpu.frontend.xla.frontend_batch``, the Pallas kernel in
interpret mode (``pallas.frontend_batch(..., interpret=True, t_tile=16)``, as
tests/test_frontend_pallas.py runs it) and the port's plain PyTorch version.
The tolerance is the Q6 gate of ``microwakeword_tpu_torch/frontend/gate.py``.
"""

import os

import numpy as np
import pytest
import torch

from microwakeword_tpu.frontend import pallas as fp
from microwakeword_tpu.frontend import xla as fx
from microwakeword_tpu_torch.frontend import gate, kernel, plain

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "frontend.npz")
GOLDEN_CLIPS = (
    "noise_2000", "noise_50", "modulated", "speechish", "silence",
    "impulses", "tone_1k", "tone_250", "tone_pulsed",
)


def _port(audio: np.ndarray, step_ms: int) -> np.ndarray:
    return plain.frontend_batch(torch.from_numpy(audio), step_ms=step_ms).numpy()


@pytest.mark.parametrize(
    "step_ms,shape",
    [
        (10, (1, 480 + 160 * 15)),  # one 16-hop tile
        (10, (2, 480 + 160 * 300 + 77)),  # 19 tiles of 16, ragged tail, batch
        (20, (2, 480 + 320 * 270)),  # 20 ms hop, 17 tiles
        (10, (1, 500)),  # a single hop
    ],
)
def test_plain_matches_xla_and_pallas(step_ms, shape):
    rng = np.random.default_rng(0)
    audio = rng.integers(-25000, 25000, shape).astype(np.int16)
    want_xla = np.asarray(fx.frontend_batch(audio, step_ms=step_ms))
    want_pallas = np.asarray(
        fp.frontend_batch(audio, step_ms=step_ms, interpret=True, t_tile=16)
    )
    got = _port(audio, step_ms)
    assert got.dtype == np.float32
    gate.assert_q6_gate(got, want_xla)
    gate.assert_q6_gate(got, want_pallas)


def test_short_audio_gives_no_frames():
    audio = np.zeros((2, 479), np.int16)
    assert _port(audio, 10).shape == (2, 0, 40)
    assert np.asarray(fx.frontend_batch(audio)).shape == (2, 0, 40)


def test_long_clip_chunked_ema():
    """T = 1101 > 1024: the EMA runs in chunks with a carried estimate."""
    rng = np.random.default_rng(2)
    audio = rng.integers(-8000, 8000, (2, 480 + 160 * 1100)).astype(np.int16)
    got = _port(audio, 10)
    assert got.shape == (2, 1101, 40)
    gate.assert_q6_gate(got, np.asarray(fx.frontend_batch(audio)))


def test_float_input():
    rng = np.random.default_rng(1)
    audio = rng.uniform(-0.9, 0.9, (2, 8000)).astype(np.float32)
    audio[0, :4] = [0.5 / 32768, 1.5 / 32768, -2.5 / 32768, 1.2]  # halves, clip
    got = _port(audio, 10)
    gate.assert_q6_gate(got, np.asarray(fx.frontend_batch(audio)))
    gate.assert_q6_gate(
        got, np.asarray(fp.frontend_batch(audio, interpret=True, t_tile=16))
    )


def test_bench_audio_is_exact():
    """The +-8000 white noise of bench.py's frontend measurement."""
    rng = np.random.default_rng(0)
    audio = rng.integers(-8000, 8000, (4, 16000)).astype(np.int16)
    for step_ms in (10, 20):
        want = np.asarray(fx.frontend_batch(audio, step_ms=step_ms))
        gate.assert_q6_gate(_port(audio, step_ms), want, exact=True)


@pytest.mark.parametrize("step_ms", [10, 20])
@pytest.mark.parametrize("clip", GOLDEN_CLIPS)
def test_golden_clips(clip, step_ms):
    d = np.load(GOLDEN)
    audio = d[f"audio_{clip}"][None]
    got = _port(audio, step_ms)
    gate.assert_q6_gate(got, np.asarray(fx.frontend_batch(audio, step_ms=step_ms)))


def test_streaming_forms_match_batch():
    rng = np.random.default_rng(3)
    audio = rng.integers(-12000, 12000, (2, 480 + 160 * 60)).astype(np.int16)
    batch = _port(audio, 10)
    frames = plain.frame_audio(torch.from_numpy(audio).float(), 10)
    sf = plain.scaled_filterbank(frames)
    est0 = plain.streaming_state_init((2,), device="cpu")
    # frontend_streaming over the whole clip is the batch form exactly
    whole, final = plain.frontend_streaming(sf, est0)
    np.testing.assert_array_equal(whole.numpy(), batch)
    # in two halves with the carried estimate
    a, mid = plain.frontend_streaming(sf[:, :30], est0)
    b, final2 = plain.frontend_streaming(sf[:, 30:], mid)
    gate.assert_q6_gate(torch.cat([a, b], dim=1).numpy(), batch)
    np.testing.assert_allclose(final2.numpy(), final.numpy(), rtol=1e-5)
    # one hop at a time
    est = est0
    steps = []
    for t in range(frames.shape[1]):
        f, est = plain.frontend_step(frames[:, t], est)
        steps.append(f)
    gate.assert_q6_gate(torch.stack(steps, dim=1).numpy(), batch)


def test_frontend_step_matches_jax():
    rng = np.random.default_rng(4)
    window = rng.integers(-9000, 9000, (3, 480)).astype(np.float32)
    est = rng.uniform(0.0, 40.0, (3, 40)).astype(np.float32)
    fj, ej = fx.frontend_step(window, est)
    ft, et = plain.frontend_step(torch.from_numpy(window), torch.from_numpy(est))
    gate.assert_q6_gate(ft.numpy(), np.asarray(fj))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5)


def test_kernel_wrapper_takes_plain_path_on_cpu():
    rng = np.random.default_rng(5)
    audio = torch.from_numpy(rng.integers(-8000, 8000, (2, 4000)).astype(np.int16))
    before = kernel.frontend_batch.launches
    got = kernel.frontend_batch(audio, step_ms=20)
    assert kernel.frontend_batch.launches == before  # no kernel launch on the CPU
    np.testing.assert_array_equal(got.numpy(), _port(audio.numpy(), 20))
    with pytest.raises(TypeError):
        kernel.frontend_batch(audio.numpy())
    with pytest.raises(ValueError):
        kernel.frontend_batch(audio, step_ms=15)


def test_gate_accepts_q6_flip_and_rejects_other_jumps():
    u = np.array([0.0, 133.0, 1000.0, 1000.0])  # q = 0, 1, and a large level
    want = u * gate.FEATURE_SCALE
    flip = np.array([133.0, 0.0, 1001.0, 1000.0]) * gate.FEATURE_SCALE
    assert gate.q6_gate(flip, want).failing == 0
    jump = np.array([0.0, 133.0, 1010.0, 1000.0]) * gate.FEATURE_SCALE
    assert gate.q6_gate(jump, want).failing == 1
    with pytest.raises(AssertionError):
        gate.assert_q6_gate(jump, want)
