"""The port's pool refresh (``data/refresh.py``) against the JAX package's.

- a regenerated pool has JAX's layout, bit for bit: clips end-aligned in
  their packed slots, front-truncated when longer;
- swaps keep the layout and change the contents (tests/test_data.py:578):
  the copy lands in the corpus's own ``chunks`` tensor, and a train step runs
  on it;
- a dead worker warns once (tests/test_data.py:766);
- a pool of another size than the packed slots warns (tests/test_data.py:796);
- ``block=True`` waits for the build; a mixed corpus refreshes its audio half;
- a host-streamed corpus with ``pool_refresh_steps`` prints the JAX
  package's notice and trains without refresh in both packages, and the
  port's run equals its run without the option, exactly
  (microwakeword_tpu/train/loop.py:605-612);
- the same runs' TensorBoard summaries: the port's event files carry the JAX
  run's tags at the JAX run's steps, and metrics.jsonl's values.
"""

import contextlib
import io
import json
import struct
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from microwakeword_tpu.data import sampler as JS
from microwakeword_tpu.data.refresh import PoolRefresher as JaxPoolRefresher
from microwakeword_tpu.data.store import FeatureHandler as JaxFeatureHandler
from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxConfig
from microwakeword_tpu.train import loop as JT
from microwakeword_tpu_torch.audio.io import save_clip
from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu_torch.data.refresh import PoolRefresher
from microwakeword_tpu_torch.data.store import FeatureHandler
from microwakeword_tpu_torch.models import build_model
from microwakeword_tpu_torch.models.mixednet import MixedNetConfig
from microwakeword_tpu_torch.train import loop as T

torch.set_num_threads(2)



class FakeAudioProvider:
    """A clips-type provider whose pool is ``clips`` (the tests swap it);
    ``fail_after`` builds, then every build raises."""

    def __init__(self, clips):
        self.sampling_weight = 1.0
        self.penalty_weight = 1.0
        self.label = 1.0
        self.truncation_strategy = "random"
        self.fixed_right_cutoffs = []
        self.clips = clips
        self.calls = 0
        self.fail_after = None

    def generate_audio_pool(self, shard_index, shard_count):
        self.calls += 1
        if self.fail_after is not None and self.calls > self.fail_after:
            raise RuntimeError("augmentation backend exploded")
        return self.clips


def _clips(rng, lengths):
    return [rng.uniform(-0.3, 0.3, n).astype(np.float32) if i % 2 else
            rng.integers(-9000, 9000, n).astype(np.int16) for i, n in enumerate(lengths)]


@pytest.mark.parametrize("step_ms", [10, 20])
def test_build_chunks_matches_jax(step_ms):
    """Two providers packed from one pool, refreshed from clips shorter and
    longer than their slots: the regenerated chunks equal JAX's."""
    rng = np.random.default_rng(0)
    providers = [FakeAudioProvider(_clips(rng, [5000, 8000, 300, 12000])),
                 FakeAudioProvider(_clips(rng, [7000, 900, 6400]))]
    packed = S.pack_audio_data(providers, "cpu", step_ms=step_ms)
    packed_jax = JS.pack_audio_data(providers, 0, 1, step_ms=step_ms)
    providers[0].clips = _clips(rng, [9000, 100, 4000, 12000])
    providers[1].clips = _clips(rng, [6400, 2000, 20000])
    fh = types.SimpleNamespace(providers=providers)
    got = PoolRefresher(fh, packed, 1)._build_chunks()
    want = JaxPoolRefresher(fh, packed_jax, 1)._build_chunks()
    assert got.dtype == want.dtype == np.int16 and got.shape == tuple(packed.chunks.shape)
    np.testing.assert_array_equal(got, want)
    # the last clip of provider 1 ran longer than its slot: its front is cut
    last = int(packed.clip_offset[-1]), int(packed.clip_chunks[-1])
    tail = providers[1].clips[-1]
    np.testing.assert_array_equal(got[last[0] : last[0] + last[1]].reshape(-1),
                                  S.clip_to_int16(tail[len(tail) - last[1] * 16 * step_ms :]))


@pytest.fixture(scope="module")
def wav_config(tmp_path_factory):
    """Two clips-type sets over gated tones (tests/test_data.py:578's task)."""
    root = tmp_path_factory.mktemp("refresh_wavs")
    rng = np.random.default_rng(0)
    t = np.arange(24000)
    gate = (np.sin(2 * np.pi * 8.0 * t / 16000) > 0).astype(np.float32)
    features = []
    for name, freqs, truth in (("pos", (2000, 2400), True), ("neg", (200, 300), False)):
        (root / name).mkdir()
        for i, f0 in enumerate(freqs):
            tone = 0.4 * gate * np.sin(2 * np.pi * f0 * t / 16000) + 0.004 * rng.standard_normal(len(t))
            save_clip(tone.astype(np.float32), str(root / name / f"c{i}.wav"))
        features.append({
            "type": "clips", "truth": truth, "sampling_weight": 1.0, "penalty_weight": 1.0,
            "truncation_strategy": "random", "pack_pool_size": 6,
            "clips_settings": {"input_directory": str(root / name), "file_pattern": "*.wav"},
            "augmentation_settings": {"augmentation_duration_s": 1.5,
                                      "augmentation_probabilities": {"Gain": 1.0}},
            "spectrogram_generation_settings": {"step_ms": 10},
        })
    return {"stride": 1, "window_step_ms": 10, "features": features}


def test_swap_keeps_layout_and_changes_contents(wav_config):
    fh = FeatureHandler(wav_config, device="cpu")
    packed = fh.pack_training_audio("cpu")
    chunks, offsets = packed.chunks, packed.clip_offset.clone()
    refresher = PoolRefresher(fh, packed, interval_steps=5)
    c1 = refresher._build_chunks()
    c2 = refresher._build_chunks()
    assert c1.shape == c2.shape == tuple(chunks.shape)
    assert not np.array_equal(c1, c2)  # fresh random augmentations
    refresher._queue.put(c2)
    assert not refresher.maybe_swap(packed, step=4)  # not due yet
    assert refresher.maybe_swap(packed, step=5)
    assert refresher.swap_count == 1
    assert packed.chunks is chunks  # copied into the corpus's own tensor
    np.testing.assert_array_equal(packed.chunks.numpy(), c2)
    np.testing.assert_array_equal(packed.clip_offset.numpy(), offsets.numpy())
    assert not refresher.maybe_swap(packed, step=12)  # due, but no pool is ready
    # the step reads the swapped tensor: no rebuild of the step is needed
    bundle = build_model("mixednet", MixedNetConfig(
        pointwise_filters=(12,), repeat_in_block=(1,), mixconv_kernel_sizes=((3,),),
        residual_connection=(False,), first_conv_filters=8, first_conv_kernel_size=3,
        spectrogram_length=40))
    model = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    step = T.make_train_step(bundle, model, packed, 8, 40, generator=torch.Generator().manual_seed(1))
    metrics = step.step(learning_rate=0.01, time_mask_max_size=0, time_mask_count=0,
                        freq_mask_max_size=0, freq_mask_count=0, positive_class_weight=1.0,
                        negative_class_weight=1.0)
    assert np.isfinite(float(metrics["loss"]))


def test_worker_death_warns():
    rng = np.random.default_rng(9)
    p = FakeAudioProvider([rng.uniform(-0.2, 0.2, 8000).astype(np.float32) for _ in range(2)])
    packed = S.pack_audio_data([p], "cpu")
    p.fail_after = p.calls  # every later pool build raises
    r = PoolRefresher(types.SimpleNamespace(providers=[p]), packed, interval_steps=1)
    r.start()
    r._thread.join(timeout=30)
    assert not r._thread.is_alive()
    assert r.failure is not None and "exploded" in r.failure
    with pytest.warns(UserWarning, match="worker died"):
        assert not r.maybe_swap(packed, step=5)
    with warnings.catch_warnings():  # once, not at every due step
        warnings.simplefilter("error")
        assert not r.maybe_swap(packed, step=10)
    r.stop()


@pytest.mark.parametrize("refreshed,word", [(2, "cycled"), (6, "truncated")])
def test_slot_mismatch_warns(refreshed, word):
    rng = np.random.default_rng(10)
    clips = [rng.uniform(-0.2, 0.2, 8000).astype(np.float32) for _ in range(6)]
    p = FakeAudioProvider(clips[:4])
    packed = S.pack_audio_data([p], "cpu")
    p.clips = clips[:refreshed]
    r = PoolRefresher(types.SimpleNamespace(providers=[p]), packed, interval_steps=1)
    with pytest.warns(UserWarning, match=f"packed slots; clips will be {word}"):
        chunks = r._build_chunks()
    assert chunks.shape == tuple(packed.chunks.shape)
    want = S.pack_audio_data([FakeAudioProvider([clips[i % refreshed] for i in range(4)])], "cpu")
    np.testing.assert_array_equal(chunks, want.chunks.numpy())


def test_blocking_swap_and_mixed_corpus(tmp_path):
    """``block=True`` waits for the worker's first pool; in a mixed corpus
    only the audio half changes."""
    rng = np.random.default_rng(11)
    p = FakeAudioProvider(_clips(rng, [4000, 4800]))  # whole chunks: end- and
    # start-aligned slots agree
    RaggedSpectrogramStore.create(str(tmp_path / "neg" / "training" / "x_mmap"),
                                  [rng.integers(0, 700, (30, 40), dtype=np.uint16)])
    spec = FeatureHandler({"features": [{"features_dir": str(tmp_path / "neg"), "truth": False,
                                         "sampling_weight": 1.0, "penalty_weight": 1.0,
                                         "truncation_strategy": "random"}]}).providers
    mixed = S.pack_mixed_data([p] + spec, "cpu")
    assert isinstance(mixed, S.PackedMixedData)
    frames = mixed.spec.frames.clone()
    p.clips = _clips(rng, [4000, 4800])
    r = PoolRefresher(types.SimpleNamespace(providers=[p]), mixed, interval_steps=3).start()
    try:
        assert r.maybe_swap(mixed, step=3, block=True)
    finally:
        r.stop()
    want = S.pack_audio_data([FakeAudioProvider(p.clips)], "cpu")
    np.testing.assert_array_equal(mixed.audio.chunks.numpy(), want.chunks.numpy())
    assert torch.equal(mixed.spec.frames, frames)
    with pytest.raises(ValueError, match="raw-audio training"):
        PoolRefresher(types.SimpleNamespace(providers=spec), mixed.spec, 1)


# ---- refresh on a corpus it does not apply to; TensorBoard summaries -------

SMALL = dict(pointwise_filters=(8, 8), repeat_in_block=(1, 1), mixconv_kernel_sizes=((3,), (5,)),
             residual_connection=(False, False), first_conv_filters=8, first_conv_kernel_size=3,
             spectrogram_length=25)


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    """A spectrogram store with validation sets, trained with
    ``corpus_residency: host``: the JAX package and the port with
    ``pool_refresh_steps: 2``, and the port without it.  Returns each run's
    printed lines, history and train_dir, and the port's final weights."""
    root = tmp_path_factory.mktemp("refresh_host")
    rng = np.random.default_rng(0)
    for name, positive, modes in (("pos", True, {"training": 20, "validation": 6}),
                                  ("neg", False, {"training": 24, "validation": 6,
                                                  "validation_ambient": 2})):
        for mode, n in modes.items():
            lo, hi = (200, 260) if mode.endswith("ambient") else (20, 60)
            specs = []
            for _ in range(n):
                spec = rng.integers(0, 80, (int(rng.integers(lo, hi)), 40)).astype(np.uint16)
                spec[:, 20:] += 300 if positive else 0
                spec[:, :20] += 0 if positive else 300
                specs.append(spec)
            RaggedSpectrogramStore.create(str(root / name / mode / "w_mmap"), specs)
    base = {
        "window_step_ms": 10, "batch_size": 16, "spectrogram_length": 25, "training_steps": [4],
        "learning_rates": [0.01], "eval_step_interval": 2, "seed": 5, "steps_per_call": 1,
        "corpus_residency": "host", "minimization_metric": "ambient_false_positives_per_hour",
        "maximization_metric": "average_viable_recall", "target_minimization": 0.9,
        "features": [{"features_dir": str(root / name), "truth": name == "pos",
                      "sampling_weight": 1.0, "penalty_weight": 1.0,
                      "truncation_strategy": "random", "type": "mmap"} for name in ("pos", "neg")],
    }
    runs = {}
    for label, refresh, package in (("jax", 2, "jax"), ("port", 2, "port"),
                                    ("port_plain", 0, "port")):
        config = dict(base, train_dir=str(root / label), pool_refresh_steps=refresh)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if package == "jax":
                _, history = JT.train(jax_build_model("mixednet", JaxConfig(**SMALL)), config,
                                      JaxFeatureHandler(config))
                state = None
            else:
                model, history = T.train(build_model("mixednet", MixedNetConfig(**SMALL)), config,
                                         FeatureHandler(config, "cpu"), device="cpu")
                state = {k: v.clone() for k, v in model.state_dict().items()}
        runs[label] = dict(printed=out.getvalue().splitlines(), history=history, state=state,
                           train_dir=config["train_dir"])
    return runs


def test_host_mode_refresh_is_ignored_as_in_jax(host_runs):
    """Both packages print the JAX notice and train; the port's losses and
    weights equal its own run without pool_refresh_steps, exactly."""
    for label in ("jax", "port"):
        assert T.REFRESH_IGNORED in host_runs[label]["printed"], label
        assert [r["step"] for r in host_runs[label]["history"]] == [2, 4], label
    assert T.REFRESH_IGNORED not in host_runs["port_plain"]["printed"]
    got, want = host_runs["port"], host_runs["port_plain"]
    assert ([r["train"]["loss"] for r in got["history"]]
            == [r["train"]["loss"] for r in want["history"]])
    assert "pool_swaps" not in got["history"][-1]
    assert all(torch.equal(got["state"][k], want["state"][k]) for k in want["state"])


def _events(log_dir) -> list:
    """(tag, step, value) of every scalar in a tensorboardX event directory
    (TFRecord framing: length, its CRC, an Event proto, its CRC)."""
    from tensorboardX.proto.event_pb2 import Event

    out = []
    for path in sorted(log_dir.iterdir()):
        data = path.read_bytes()
        i = 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i : i + 8])
            event = Event.FromString(data[i + 12 : i + 12 + n])
            i += 12 + n + 4
            out += [(v.tag, event.step, v.simple_value) for v in event.summary.value]
    return out


def test_tensorboard_summaries_match_jax(host_runs):
    """logs/train and logs/validation hold the JAX run's tags at its steps,
    with the values of the port's metrics.jsonl (float32 in the events)."""
    port, jax_run = Path(host_runs["port"]["train_dir"]), Path(host_runs["jax"]["train_dir"])
    records = [json.loads(ln) for ln in (port / "metrics.jsonl").read_text().splitlines()]
    for split, key in (("train", "train"), ("validation", "validation")):
        got = _events(port / "logs" / split)
        want = _events(jax_run / "logs" / split)
        assert len(got) == len(want) > 0, split
        assert sorted((t, s) for t, s, _ in got) == sorted((t, s) for t, s, _ in want), split
        values = {(tag, r["step"]): np.float32(v) for r in records for tag, v in r[key].items()}
        for tag, step, value in got:
            assert np.float32(value) == values[(tag, step)], (split, tag, step)
