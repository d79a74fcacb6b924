"""Float PCM through the port's per-clip entry points against the JAX package's.

The JAX package's per-clip frontend (``frontend/reference.py
generate_features_for_clip``) truncates float samples to int16
(``np.clip(x * 32768, -32768, 32767).astype(np.int16)``); ``Model.predict_clip``
and ``SpectrogramGeneration``'s default frontend go through it.  The port's
counterparts convert by the same rule (``plain.float_pcm_to_int16``) before
``frontend_batch``, which itself rounds, as ``xla.py`` does.  On a float clip
where the two rules differ, the features must equal the JAX ones cell for
cell (the Q6 gate is the floor), and ``predict_clip``'s probabilities must
equal those of the JAX ``Model.predict_clip`` with the flagship's weights
carried across by ``models/convert.py``.
"""

import jax
import numpy as np
import pytest
import torch

from microwakeword_tpu.audio.spectrograms import SpectrogramGeneration as JaxSpectrogramGeneration
from microwakeword_tpu.frontend import reference
from microwakeword_tpu.inference import Model as JaxModel
from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models import presets as jax_presets
from microwakeword_tpu_torch.audio.spectrograms import SpectrogramGeneration
from microwakeword_tpu_torch.frontend import frontend_batch, gate
from microwakeword_tpu_torch.frontend.plain import float_pcm_to_int16
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import build_model, convert, presets

torch.set_num_threads(2)


def _float_clip(seconds: float = 3.0, dtype=np.float32) -> np.ndarray:
    """A gated 440 Hz tone plus noise, float in [-1, 1]."""
    rng = np.random.default_rng(11)
    t = np.arange(int(seconds * 16000)) / 16000.0
    gate_env = np.maximum(np.sin(2 * np.pi * 3.0 * t), 0.0) ** 2
    x = 0.3 * gate_env * np.sin(2 * np.pi * 440.0 * t) + 0.01 * rng.standard_normal(t.shape)
    return x.astype(dtype)


def _rounded(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip(x * 32768.0, -32768.0, 32767.0)).astype(np.int16)


def test_float_pcm_to_int16_is_the_reference_rule():
    x = np.array([0.5 / 32768, 1.5 / 32768, -0.5 / 32768, -2.7 / 32768, 0.99999, -1.0, 1.2, -1.3],
                 np.float32)
    got = float_pcm_to_int16(x)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, [0, 1, 0, -2, 32767, -32768, 32767, -32768])
    for dtype in (np.float32, np.float64):
        clip = _float_clip(0.5, dtype)
        np.testing.assert_array_equal(
            float_pcm_to_int16(clip), np.clip(clip * 32768, -32768, 32767).astype(np.int16))


def test_the_clip_tells_truncation_from_rounding():
    """The test clip is one where the two rules give different features, so
    the tests below would see a port that rounds."""
    clip = _float_clip()
    want = reference.generate_features_for_clip(clip, 10)
    rounded = frontend_batch(torch.from_numpy(_rounded(clip))[None], 10)[0].numpy()
    assert gate.q6_gate(rounded, want).exact < gate.q6_gate(want, want).exact


@pytest.mark.parametrize("step_ms", [10, 20])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spectrogram_generation_frontend_matches_jax_default(step_ms, dtype):
    """SpectrogramGeneration.frontend against the JAX default frontend on float
    PCM: every cell equal at 10 ms; at 20 ms the Q6 gate (the plain frontend
    and the NumPy reference leave one one-level Q6 flip in this clip's 5,960
    cells, on float and int16 input alike)."""
    exact = step_ms == 10
    clip = _float_clip(dtype=dtype)
    port = SpectrogramGeneration(None, step_ms=step_ms, device="cpu")
    jax_sg = JaxSpectrogramGeneration(None, step_ms=step_ms)
    got, want = port.frontend(clip), jax_sg.frontend(clip)
    assert got.shape == want.shape == (reference.generate_features_for_clip(clip, step_ms).shape)
    res = gate.assert_q6_gate(got, want, exact=exact)
    # int16 input is taken as it is
    pcm = float_pcm_to_int16(clip)
    assert gate.assert_q6_gate(port.frontend(pcm), jax_sg.frontend(pcm), exact=exact) == res


def test_predict_clip_matches_jax_on_float_pcm():
    """The flagship's predict_clip, port against JAX, on the same float clip."""
    jb = jax_build_model("mixednet", jax_presets.flagship_config())
    variables = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.2, 1.0, a.shape).astype(np.float32), variables["batch_stats"])
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    tb = build_model("mixednet", presets.flagship_config())
    port = Model.from_torch(tb, convert.flax_to_state(variables), device="cpu")
    want_model = JaxModel.from_jax(jb, variables)

    clip = _float_clip()
    got = port.predict_clip(clip)
    want = np.asarray(want_model.predict_clip(clip))
    assert got.shape == want.shape == (reference.generate_features_for_clip(clip).shape[0] // 3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the features predict_clip runs on are the JAX ones, cell for cell
    feats = frontend_batch(torch.from_numpy(float_pcm_to_int16(clip))[None], 10)[0].numpy()
    gate.assert_q6_gate(feats, reference.generate_features_for_clip(clip), exact=True)
    # int16 PCM goes through unchanged
    pcm = float_pcm_to_int16(clip)
    np.testing.assert_array_equal(port.predict_clip(pcm), got)
