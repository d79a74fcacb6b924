"""The port's offline audio pipeline against the JAX package's.

Both packages read the same WAV files through their defaults: the native
decoder, resampler and VAD (``native/src/mww_native.cc``), which the JAX
package loads as ``microwakeword_tpu.native`` and the port builds and binds
as ``microwakeword_tpu_torch.native``.

- ``load_audio``, ``save_clip``, ``wav_duration_seconds``, ``remove_silence``,
  every DSP primitive, ``Augmentation`` and ``Clips`` (split, repeat, VAD,
  duration filter) give bit-equal arrays from the same seeds;
- ``SpectrogramGeneration`` on the CPU (the port's plain frontend) matches
  the JAX package's default one (its NumPy golden frontend; both truncate
  float clips to int16) to tests/test_frontend_xla.py's tolerance (share of
  cells off by > 0.5 below 0.003, median 0), and ``xla.frontend_batch`` on
  the truncated samples under the Q6 gate, split and slide included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from microwakeword_tpu.audio import augmentation as JA
from microwakeword_tpu.audio import clips as JC
from microwakeword_tpu.audio import dsp as JD
from microwakeword_tpu.audio import io as JIO
from microwakeword_tpu.audio import spectrograms as JSG
from microwakeword_tpu.audio import vad as JV
from microwakeword_tpu.frontend import xla as JX
from microwakeword_tpu_torch.audio import augmentation as A
from microwakeword_tpu_torch.audio import clips as C
from microwakeword_tpu_torch.audio import dsp as D
from microwakeword_tpu_torch.audio import io as IO
from microwakeword_tpu_torch.audio import spectrograms as SG
from microwakeword_tpu_torch.audio import vad as V
from microwakeword_tpu_torch.frontend import gate
from microwakeword_tpu_torch.frontend.plain import float_pcm_to_int16

torch.set_num_threads(2)

ALL_ON = {name: 1.0 for name in JA.DEFAULT_PROBABILITIES}



def _gated_tone(rng, seconds, f0, amp=0.4):
    t = np.arange(int(seconds * 16000))
    gate_ = (np.sin(2 * np.pi * 8.0 * t / 16000) > 0).astype(np.float32)
    tone = amp * gate_ * np.sin(2 * np.pi * f0 * t / 16000)
    return (tone + 0.004 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """clips/ (gated tones with silent gaps, 0.4 to 1.4 s), bg/ (noise),
    rir/ (decaying impulses), odd/ (8 kHz int16, stereo int32, uint8)."""
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    for d in ("clips", "bg", "rir", "odd"):
        (root / d).mkdir()
    for i in range(7):
        clip = _gated_tone(rng, 0.4 + 0.15 * i, 300.0 + 350.0 * i)
        clip[: 1600 * (i % 3)] = 0.0  # leading silence for trim_zeros and the VAD
        IO.save_clip(clip, str(root / "clips" / f"c{i}.wav"))
    for i in range(2):
        IO.save_clip((0.1 * rng.standard_normal(24000 + 4000 * i)).astype(np.float32),
                     str(root / "bg" / f"b{i}.wav"))
    for i in range(2):
        n = 800 + 400 * i
        ir = rng.standard_normal(n) * np.exp(-np.arange(n) / (120.0 + 100 * i))
        IO.save_clip((0.5 * ir / np.abs(ir).max()).astype(np.float32), str(root / "rir" / f"r{i}.wav"))
    wavfile.write(str(root / "odd" / "k8.wav"), 8000,
                  (8000 * rng.standard_normal(4000)).astype(np.int16))
    wavfile.write(str(root / "odd" / "stereo32.wav"), 16000,
                  (1e8 * rng.standard_normal((3000, 2))).astype(np.int32))
    wavfile.write(str(root / "odd" / "u8.wav"), 22050,
                  rng.integers(0, 256, 5000).astype(np.uint8))
    return root


@pytest.mark.parametrize("name", ["clips/c3.wav", "odd/k8.wav", "odd/stereo32.wav", "odd/u8.wav"])
def test_load_audio_and_duration_match_jax(wavs, name):
    path = str(wavs / name)
    want = JIO.load_audio(path)
    got = IO.load_audio(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert IO.wav_duration_seconds(path) == JIO.wav_duration_seconds(path)


def test_save_clip_matches_jax(tmp_path):
    audio = np.random.default_rng(1).uniform(-1, 1, 3000).astype(np.float32)
    IO.save_clip(audio, str(tmp_path / "port.wav"))
    JIO.save_clip(audio, str(tmp_path / "jax.wav"))
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
def test_remove_silence_matches_jax(dtype):
    rng = np.random.default_rng(2)
    audio = np.concatenate([0.002 * rng.standard_normal(8000), _gated_tone(rng, 1.0, 900.0),
                            0.002 * rng.standard_normal(6000)])
    if dtype == np.int16:
        audio = (audio * 32767).astype(np.int16)
    else:
        audio = audio.astype(dtype)
    want = JV.remove_silence(audio)
    got = V.remove_silence(audio)
    assert got.dtype == want.dtype and 0 < len(got) < len(audio)
    np.testing.assert_array_equal(got, want)


def _dsp_cases(wavs):
    bg = JIO.load_audio(str(wavs / "bg" / "b0.wav"))
    ir = JIO.load_audio(str(wavs / "rir" / "r1.wav"))
    return {
        "seven_band_parametric_eq": lambda m, a, r: m.seven_band_parametric_eq(a, r),
        "tanh_distortion": lambda m, a, r: m.tanh_distortion(a, r),
        "pitch_shift": lambda m, a, r: m.pitch_shift(a, r),
        "band_stop_filter": lambda m, a, r: m.band_stop_filter(a, r),
        "colored_noise": lambda m, a, r: m.colored_noise(len(a), r, 3.0),
        "add_colored_noise": lambda m, a, r: m.add_colored_noise(a, r),
        "add_background_noise": lambda m, a, r: m.add_background_noise(a, bg, r),
        "add_background_noise short": lambda m, a, r: m.add_background_noise(a, bg[:5000], r),
        "gain": lambda m, a, r: m.gain(a, r),
        "gain_transition": lambda m, a, r: m.gain_transition(a, r),
        "apply_impulse_response": lambda m, a, r: m.apply_impulse_response(a, ir),
        "normalize_if_clipped": lambda m, a, r: m.normalize_if_clipped(3.0 * a),
    }


@pytest.mark.parametrize("case", [
    "seven_band_parametric_eq", "tanh_distortion", "pitch_shift", "band_stop_filter",
    "colored_noise", "add_colored_noise", "add_background_noise", "add_background_noise short",
    "gain", "gain_transition", "apply_impulse_response", "normalize_if_clipped"])
def test_dsp_matches_jax(wavs, case):
    fn = _dsp_cases(wavs)[case]
    audio = _gated_tone(np.random.default_rng(3), 0.75, 1200.0)
    want = fn(JD, audio, np.random.default_rng(4))
    got = fn(D, audio, np.random.default_rng(4))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _augmenters(wavs, **kw):
    args = dict(impulse_paths=[str(wavs / "rir")], background_paths=[str(wavs / "bg")], **kw)
    return JA.Augmentation(**args), A.Augmentation(**args)


@pytest.mark.parametrize("kw", [
    dict(augmentation_duration_s=1.2, augmentation_probabilities=ALL_ON, seed=5),
    dict(augmentation_duration_s=0.5, min_jitter_s=0.05, max_jitter_s=0.3, truncate_randomly=True,
         seed=6),
    dict(seed=7),  # default probabilities, no fixed size
])
def test_augmentation_matches_jax(wavs, kw):
    jax_aug, port_aug = _augmenters(wavs, **kw)
    assert port_aug.probabilities == jax_aug.probabilities
    for i in (0, 3, 6, 2):
        audio = JIO.load_audio(str(wavs / "clips" / f"c{i}.wav"))
        want = jax_aug.augment_clip(audio)
        got = port_aug.augment_clip(audio)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(random_split_seed=3, split_count=0.2, seed=1),
    dict(random_split_seed=4, split_count=1, repeat_clip_min_duration_s=1.5, seed=2),
    dict(remove_silence=True, trim_zeros=True, trimmed_clip_duration_s=0.8, seed=3),
    dict(min_clip_duration_s=0.6, max_clip_duration_s=1.2, seed=4),
])
def test_clips_match_jax(wavs, kw):
    jax_clips = JC.Clips(str(wavs / "clips"), **kw)
    port_clips = C.Clips(str(wavs / "clips"), **kw)
    assert port_clips.clips == jax_clips.clips and len(port_clips.clips) > 1
    assert port_clips.split_clips == jax_clips.split_clips
    splits = [None] + (["train", "test", "validation"] if jax_clips.split_clips else [])
    for split in splits:
        pairs = zip(port_clips.audio_generator(split, repeat=2), jax_clips.audio_generator(split, repeat=2))
        for got, want in pairs:
            np.testing.assert_array_equal(got, want)
    for got, want in zip(port_clips.random_audio_generator(5), jax_clips.random_audio_generator(5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sg_kw", [
    dict(step_ms=10), dict(step_ms=20),
    dict(step_ms=10, split_spectrogram_duration_s=0.3), dict(step_ms=10, slide_frames=4),
])
def test_spectrogram_generation_matches_jax(wavs, sg_kw):
    """Golden tolerance against the NumPy frontend; the Q6 gate against
    xla.frontend_batch on the same augmented audio."""
    def make(aug_mod, clips_mod, sg_mod, **extra):
        clips = clips_mod.Clips(str(wavs / "clips"), seed=8)
        aug = aug_mod.Augmentation(augmentation_duration_s=1.0, seed=9,
                                   background_paths=[str(wavs / "bg")])
        return sg_mod.SpectrogramGeneration(clips, aug, **sg_kw, **extra)

    # The JAX default frontend (the golden, generate_features_for_clip)
    # truncates float samples to int16 (reference.py:220), and so does the
    # port's SpectrogramGeneration.frontend (plain.float_pcm_to_int16).
    want = list(make(JA, JC, JSG).spectrogram_generator())
    got = list(make(A, C, SG, device="cpu").spectrogram_generator())
    assert len(got) == len(want) >= 7
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)
                        if g.shape == w.shape])
    assert all(g.shape == w.shape for g, w in zip(got, want))
    assert (d > 0.5).mean() < 0.003 and np.median(d) == 0.0

    # the same augmented clips through the JAX package's XLA frontend
    clips = C.Clips(str(wavs / "clips"), seed=8)
    aug = A.Augmentation(augmentation_duration_s=1.0, seed=9, background_paths=[str(wavs / "bg")])
    sg = SG.SpectrogramGeneration(clips, aug, **sg_kw, device="cpu")
    xla = [v for clip in aug.augment_generator(clips.audio_generator())
           for v in sg.postprocess(np.asarray(JX.frontend_batch(
               jnp.asarray(float_pcm_to_int16(clip))[None], step_ms=sg_kw["step_ms"]))[0])]
    assert len(xla) == len(got)
    gate.assert_q6_gate(np.concatenate(got), np.concatenate(xla))


def test_batched_spectrograms_match_one_by_one(wavs):
    """batched_spectrograms (one frontend call per batch, clips zero-padded to
    the longest) gives each clip the uint16 features of its own call."""
    clips = C.Clips(str(wavs / "clips"))
    sg = SG.SpectrogramGeneration(clips, None, step_ms=10, device="cpu")
    audio = list(clips.audio_generator())
    batched = list(sg.batched_spectrograms(audio, "cpu", batch=3))
    alone = [SG.features_to_uint16(sg.frontend(a)) for a in audio]
    assert [b.shape for b in batched] == [a.shape for a in alone]
    gate.assert_q6_gate(np.concatenate(batched) * 0.0390625, np.concatenate(alone) * 0.0390625)
