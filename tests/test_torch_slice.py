"""The whole serving slice on the CPU: PCM -> features -> streaming MixedNet.

Two golden PCM clips, batched, go through the port's ``frontend_batch`` and a
flagship-shaped MixedNet at reduced width (``stream_scan``), and through the
JAX package's ``xla.frontend_batch`` and ``bundle.stream_scan`` with the same
weights moved by ``models/convert.py``.
"""

import os

import jax
import numpy as np
import torch

from microwakeword_tpu.frontend import xla as fx
from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxConfig
from microwakeword_tpu_torch.frontend import frontend_batch, gate
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import MixedNetConfig, build_model, convert

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "frontend.npz")
# The flagship's shape (kernels, first conv k5 s3, 204 input frames) at width 16.
SLICE_CONFIG = dict(
    pointwise_filters=(16, 16, 16, 16),
    repeat_in_block=(1, 1, 1, 1),
    mixconv_kernel_sizes=((5,), (7, 11), (9, 15), (23,)),
    residual_connection=(False, False, False, False),
    first_conv_filters=8,
    first_conv_kernel_size=5,
    stride=3,
    spectrogram_length=204,
)


def _weights():
    jb = jax_build_model("mixednet", JaxConfig(**SLICE_CONFIG))
    variables = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.2, 1.0, a.shape).astype(np.float32), variables["batch_stats"]
    )
    return jb, {k: variables[k] for k in ("params", "batch_stats")}


def test_slice_matches_jax_and_predict_clip():
    d = np.load(GOLDEN)
    audio = np.stack([d["audio_modulated"], d["audio_speechish"]])  # [2, 32000] int16

    feats = frontend_batch(torch.from_numpy(audio), step_ms=10)
    feats_jax = np.asarray(fx.frontend_batch(audio, step_ms=10))
    assert feats.shape == (2, 198, 40)
    gate.assert_q6_gate(feats.numpy(), feats_jax, exact=True)

    jb, variables = _weights()
    tb = build_model("mixednet", MixedNetConfig(**SLICE_CONFIG))
    state = convert.flax_to_state(variables)
    model = tb.load(state, device="cpu")
    probs = tb.stream_scan(model, feats)
    want = np.asarray(jb.stream_scan(variables, feats_jax))
    assert probs.shape == want.shape == (2, 66, 1)
    np.testing.assert_allclose(probs.numpy(), want, atol=1e-5)
    assert np.isfinite(probs.numpy()).all()

    runner = Model.from_torch(tb, state, device="cpu")
    clip_probs = runner.predict_clip(audio[1])
    assert clip_probs.shape == (198 // 3,)
    np.testing.assert_allclose(clip_probs, probs[1, :, 0].numpy(), atol=1e-6)
    spec_probs = runner.predict_spectrogram(feats_jax[0])
    np.testing.assert_allclose(spec_probs, want[0, :, 0], atol=1e-5)
