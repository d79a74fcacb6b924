"""clips-type feature sets and the dataset build against the JAX package.

The same WAV files and seeds in both packages, both reading them through
their native decoders (the JAX package's default):

- ``ClipsFeatureSet.generate_audio_pool`` is bit-equal to JAX's;
- ``generate_pool`` (the port's batched frontend on the CPU) matches JAX's
  (``xla.frontend_batch``) under the Q6 gate on the uint16 values, with the
  same clip lengths;
- ``build_dataset.build_feature_dir`` writes the stores JAX's writes: the
  same paths, counts and lengths, the values under the Q6 gate;
- ``type: clips`` sets pack into the spectrogram corpus as JAX's do.
"""

import os

import numpy as np
import pytest
import torch

from microwakeword_tpu import build_dataset as jax_build
from microwakeword_tpu.data import sampler as JS
from microwakeword_tpu.data.ragged_store import RaggedSpectrogramStore as JaxStore
from microwakeword_tpu.data.store import FeatureHandler as JaxFeatureHandler
from microwakeword_tpu_torch import build_dataset
from microwakeword_tpu_torch.audio.io import save_clip
from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu_torch.data.store import ClipsFeatureSet, FeatureHandler
from microwakeword_tpu_torch.frontend import gate

torch.set_num_threads(2)

SCALE = 0.0390625



@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """pos/ gated 2-2.4 kHz tones, neg/ low tones, bg/ noise, amb/ two long
    noise tracks."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    for name, freqs, seconds in (("pos", (2000, 2200, 2400), 1.0), ("neg", (200, 300, 450), 0.8)):
        (root / name).mkdir()
        for i, f0 in enumerate(freqs * 3):
            t = np.arange(int(seconds * 16000) + 800 * i)
            gate_ = (np.sin(2 * np.pi * 8.0 * t / 16000) > 0).astype(np.float32)
            tone = 0.4 * gate_ * np.sin(2 * np.pi * f0 * t / 16000) + 0.004 * rng.standard_normal(len(t))
            save_clip(tone.astype(np.float32), str(root / name / f"c{i}.wav"))
    for name, n, seconds in (("bg", 2, 2.0), ("amb", 2, 6.0)):
        (root / name).mkdir()
        for i in range(n):
            save_clip((0.05 * rng.standard_normal(int(seconds * 16000))).astype(np.float32),
                      str(root / name / f"{name}{i}.wav"))
    return root


def clips_feature(wavs, name="pos", truth=True, pool=6, step_ms=10):
    return {
        "type": "clips", "truth": truth, "sampling_weight": 1.0, "penalty_weight": 1.0,
        "truncation_strategy": "random", "pack_pool_size": pool,
        "clips_settings": {"input_directory": str(wavs / name), "file_pattern": "*.wav", "seed": 3},
        "augmentation_settings": {"augmentation_duration_s": 1.1, "seed": 4,
                                  "background_paths": [str(wavs / "bg")],
                                  "augmentation_probabilities": {"Gain": 1.0, "AddBackgroundNoise": 0.5,
                                                                 "AddColorNoise": 0.5}},
        "spectrogram_generation_settings": {"step_ms": step_ms},
    }


def _handlers(wavs, **kw):
    config = {"window_step_ms": kw.get("step_ms", 10), "features": [clips_feature(wavs, **kw)]}
    return JaxFeatureHandler(config), FeatureHandler(config, device="cpu")


@pytest.mark.parametrize("shard", [(0, 1), (1, 4)])
def test_generate_audio_pool_matches_jax(wavs, shard):
    jax_fh, fh = _handlers(wavs, pool=9)
    assert isinstance(fh.providers[0], ClipsFeatureSet)
    assert fh.get_mode_size("training") == jax_fh.get_mode_size("training") == 9
    want = jax_fh.providers[0].generate_audio_pool(*shard)
    got = fh.providers[0].generate_audio_pool(*shard)
    assert len(got) == len(want) == 9 // shard[1]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("step_ms", [10, 20])
def test_generate_pool_matches_jax(wavs, step_ms):
    jax_fh, fh = _handlers(wavs, pool=7, step_ms=step_ms)
    want, want_lengths = jax_fh.providers[0].generate_pool(0, 1)
    got, lengths = fh.providers[0].generate_pool(0, 1, "cpu")
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(lengths, want_lengths)
    gate.assert_q6_gate(got * SCALE, want * SCALE)


def test_clips_sets_pack_into_spectrogram_corpus(wavs):
    jax_fh, fh = _handlers(wavs, pool=5)
    want = JS.pack_training_arrays(jax_fh.providers, 0, 1)
    got = S.pack_training_arrays(fh.providers, 0, 1, device="cpu")
    assert set(got) == set(want)
    for key, value in want.items():
        if key != "frames":
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    gate.assert_q6_gate(got["frames"] * SCALE, want["frames"] * SCALE)
    assert fh.providers[0].get_random_spectrogram("training", 30, "default").shape == (30, 40)
    assert fh.get_mode_size("validation") == 0


def _dataset_docs(wavs, out):
    return [
        {"output_dir": str(out / "pos"), "name": "wakeword",
         "clips": {"input_directory": str(wavs / "pos"), "random_split_seed": 10, "split_count": 0.2,
                   "seed": 1},
         "augmentation": {"augmentation_duration_s": 1.2, "seed": 2,
                          "background_paths": [str(wavs / "bg")],
                          "augmentation_probabilities": {"Gain": 1.0, "AddBackgroundNoise": 1.0}},
         "spectrogram_generation": {"step_ms": 10, "slide_frames": 3},
         "splits": {"training": {"split": "train", "repeat": 2}, "testing": {"split": "test"},
                    "validation": {"split": "validation"}}},
        {"output_dir": str(out / "amb"), "name": "ambient",
         "clips": {"input_directory": str(wavs / "amb")},
         "spectrogram_generation": {"step_ms": 20, "split_spectrogram_duration_s": 1.5},
         "splits": {"testing_ambient": {"split": None}, "validation_ambient": None}},
    ]


def test_build_dataset_matches_jax(wavs, tmp_path):
    for doc_jax, doc in zip(_dataset_docs(wavs, tmp_path / "jax"), _dataset_docs(wavs, tmp_path / "port")):
        want = jax_build.build_feature_dir(doc_jax, log=lambda *a: None)
        got = build_dataset.build_feature_dir(doc, "cpu", log=lambda *a: None)
        assert got == want and all(count > 0 for count, _ in got.values())
    names = sorted(os.path.relpath(p, tmp_path / "jax") for p, _, files in os.walk(tmp_path / "jax")
                   if "meta.json" in files)
    assert names == sorted(os.path.relpath(p, tmp_path / "port")
                           for p, _, files in os.walk(tmp_path / "port") if "meta.json" in files)
    assert len(names) == 5
    for name in names:
        want, got = JaxStore(str(tmp_path / "jax" / name)), RaggedSpectrogramStore(str(tmp_path / "port" / name))
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got.offsets, want.offsets)
        gate.assert_q6_gate(np.asarray(got.data) * SCALE, np.asarray(want.data) * SCALE)


def test_build_dataset_cli_reads_yaml(wavs, tmp_path):
    import yaml

    docs = _dataset_docs(wavs, tmp_path)
    with open(tmp_path / "dataset.yaml", "w") as f:
        yaml.safe_dump_all(docs, f)
    assert build_dataset.main(["--config", str(tmp_path / "dataset.yaml"), "--device", "cpu"]) == 0
    store = RaggedSpectrogramStore(str(tmp_path / "amb" / "testing_ambient" / "ambient_mmap"))
    assert len(store) > 2 and store.data.shape[1] == 40
