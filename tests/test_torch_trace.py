"""The port's layer spans (``microwakeword_tpu_torch/trace.py``) under the
CPU profiler, and the train loop's ``steps_per_sec``.

- ``span`` is the shared null context with no profiler running and a
  ``record_function`` range under one;
- a train step yields one ``train.step`` per sub-step holding
  ``train.sample``, ``train.forward``, ``train.backward`` and ``train.adam``
  in that order, then one ``train.report``, on spectrograms and through
  ``step_on_batch``;
- ``stream_scan`` yields one ``stream.step`` per step inside ``stream.scan``;
  ``predict_clip`` yields ``predict.clip`` holding ``predict.copy_in``,
  ``frontend.batch``, ``stream.scan`` and ``predict.copy_out`` in order;
  ``ambient_accept_counts`` yields one ``accept.counts`` (and on the CPU
  no ``accept.kernel``);
- spans change no number: losses, parameters, streamed probabilities and
  accept counts are bitwise equal with the profiler on and off;
- ``steps_per_sec`` counts steps done: with one eval at the end it is the
  steps over the loop's own time.
"""

import contextlib
import math
import time
import types

import numpy as np
import pytest
import torch

from microwakeword_tpu_torch import trace
from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu_torch.data.store import FeatureHandler
from microwakeword_tpu_torch.evaluate import roc
from microwakeword_tpu_torch.evaluate.streaming_eval import ambient_accept_counts
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import build_model
from microwakeword_tpu_torch.models.mixednet import MixedNetConfig
from microwakeword_tpu_torch.train import loop as T

torch.set_num_threads(2)

SPANS = {"train.step", "train.sample", "train.forward", "train.backward", "train.adam",
         "train.report", "frontend.batch", "stream.scan", "stream.step", "accept.counts",
         "accept.kernel", "predict.clip", "predict.copy_in", "predict.copy_out", "refresh.swap"}
L, B, STRIDE = 25, 8, 3
CFG = dict(pointwise_filters=(8, 8), repeat_in_block=(1, 1), mixconv_kernel_sizes=((3,), (5,)),
           residual_connection=(False, False), first_conv_filters=8, first_conv_kernel_size=3,
           stride=STRIDE, spectrogram_length=L)
PHASE = dict(learning_rate=1e-2, time_mask_max_size=3, time_mask_count=1, freq_mask_max_size=3,
             freq_mask_count=1, positive_class_weight=1.0, negative_class_weight=2.0)


@contextlib.contextmanager
def _profiled(on: bool = True):
    """The CPU profiler around the block (or nothing); yields a list that
    holds the spans recorded, (name, parent span's name) in order of start."""
    got = []
    if not on:
        yield got
        return
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield got
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name in SPANS:
            parent = e.cpu_parent
            while parent is not None and parent.name not in SPANS:
                parent = parent.cpu_parent
            got.append((e.name, None if parent is None else parent.name))


def _bundle():
    return build_model("mixednet", MixedNetConfig(**CFG))


def _model(bundle):
    return bundle.init(torch.Generator().manual_seed(3), device="cpu")


def _provider(label: float, rng) -> types.SimpleNamespace:
    lens = rng.integers(30, 50, 6)
    data = rng.integers(0, 600, (int(lens.sum()), 40)).astype(np.uint16)
    store = types.SimpleNamespace(data=data, offsets=np.concatenate([[0], np.cumsum(lens)]))
    return types.SimpleNamespace(sampling_weight=1.0, label=label, penalty_weight=1.0,
                                 truncation_strategy="random", fixed_right_cutoffs=[],
                                 stores={"training": [store]})


def _packed():
    rng = np.random.default_rng(0)
    return S.pack_training_data([_provider(1.0, rng), _provider(0.0, rng)], "cpu")


def _batches(n: int):
    """n gathered batches stacked on a leading [steps] axis, as
    ``step_on_batch`` takes several sub-steps."""
    rng = np.random.default_rng(1)
    windows = S.frames_tensor(rng.integers(0, 600, (n, B, L, 40)).astype(np.uint16))
    valid = torch.ones((n, B, L), dtype=torch.bool)
    labels = torch.from_numpy((rng.uniform(size=(n, B)) < 0.5).astype(np.float32))
    return windows, valid, labels, torch.ones((n, B))


def _train(path: str, calls: int, steps: int, profile: bool):
    """``calls`` calls of ``steps`` sub-steps each; (losses, flat
    parameters, spans)."""
    bundle = _bundle()
    step = T.make_train_step(bundle, _model(bundle), _packed(), B, L, steps,
                             torch.Generator().manual_seed(7))
    losses = []
    with _profiled(profile) as spans:
        for _ in range(calls):
            if path == "spectrograms":
                out = step.step(**PHASE)
            else:
                out = step.step_on_batch(*_batches(steps), **PHASE)
            losses.append(out["loss"].clone())
    return torch.stack(losses), step.flat.clone(), spans


def _pcm(seconds: float, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-3000, 3000, int(seconds * 16000)).astype(np.int16)


@pytest.mark.parametrize("profiling", [False, True])
def test_span_is_null_without_profiler(profiling):
    with _profiled(profiling):
        got = trace.span("x")
    if profiling:
        assert isinstance(got, torch.profiler.record_function)
    else:
        assert got is trace.span("y")
        assert isinstance(got, contextlib.nullcontext)


@pytest.mark.parametrize("path", ["spectrograms", "step_on_batch"])
def test_train_step_spans(path):
    """Two sub-steps in one call: two ``train.step`` with their four phases
    in order, then one ``train.report`` beside them."""
    *_, spans = _train(path, calls=1, steps=2, profile=True)
    phases = [("train.sample", "train.step"), ("train.forward", "train.step"),
              ("train.backward", "train.step"), ("train.adam", "train.step")]
    want = ([("train.step", None)] + phases) * 2 + [("train.report", None)]
    assert spans == want


def test_stream_scan_spans():
    bundle = _bundle()
    x = torch.rand((2, 20, 40)) * 20
    with _profiled() as spans:
        probs = bundle.stream_scan(_model(bundle), x)
    assert probs.shape == (2, 20 // STRIDE, 1)
    assert spans == [("stream.scan", None)] + [("stream.step", "stream.scan")] * (20 // STRIDE)


def test_predict_clip_spans():
    bundle = _bundle()
    model = Model.from_torch(bundle, _model(bundle).state_dict(), "cpu")
    with _profiled() as spans:
        probs = model.predict_clip(_pcm(0.5))
    assert len(probs) == 48 // STRIDE  # 49 frames of 0.5 s at 10 ms
    outer = [s for s in spans if s[0] != "stream.step"]
    assert outer == [("predict.clip", None), ("predict.copy_in", "predict.clip"),
                     ("frontend.batch", "predict.clip"), ("stream.scan", "predict.clip"),
                     ("predict.copy_out", "predict.clip")]


def test_accept_counts_span():
    probs = torch.rand((3, 60), generator=torch.Generator().manual_seed(4))
    with _profiled() as spans:
        ambient_accept_counts([probs], roc.DEFAULT_CUTOFFS, 25, 5, stride=STRIDE)
    assert spans == [("accept.counts", None)]


def _stream(profile: bool):
    bundle = _bundle()
    model = Model.from_torch(bundle, _model(bundle).state_dict(), "cpu")
    with _profiled(profile):
        probs = np.stack([model.predict_clip(_pcm(1.0, seed)) for seed in range(3)])
        counts, _ = ambient_accept_counts([torch.from_numpy(probs)], roc.DEFAULT_CUTOFFS, 25, 5,
                                          stride=STRIDE)
    return probs, counts


@pytest.mark.parametrize("what", ["train_spectrograms", "train_step_on_batch", "stream"])
def test_spans_change_no_number(what):
    """Three steps' losses and parameters, or streamed probabilities and
    accept counts, equal bit for bit with the profiler on and off."""
    if what == "stream":
        (p0, c0), (p1, c1) = _stream(False), _stream(True)
        np.testing.assert_array_equal(p0, p1)
        np.testing.assert_array_equal(c0, c1)
        assert c0.sum() > 0  # the comparison saw accepts
        return
    path = what.removeprefix("train_")
    loss0, flat0, _ = _train(path, calls=3, steps=1, profile=False)
    loss1, flat1, _ = _train(path, calls=3, steps=1, profile=True)
    assert torch.equal(loss0, loss1) and torch.equal(flat0, flat1)


def test_steps_per_sec_counts_steps_done(tmp_path, monkeypatch):
    """One eval at the end: ``steps_per_sec`` is the steps over the time of
    the loop that ran them, within 20 %."""
    rng = np.random.default_rng(5)
    for name, positive in (("pos", True), ("neg", False)):
        specs = [rng.integers(0, 600, (int(rng.integers(30, 50)), 40)).astype(np.uint16)
                 for _ in range(8)]
        RaggedSpectrogramStore.create(str(tmp_path / name / "training" / "w_mmap"), specs)
    steps = 40
    config = {"window_step_ms": 10, "batch_size": B, "spectrogram_length": L,
              "training_steps": [steps], "learning_rates": [0.01], "eval_step_interval": steps,
              "seed": 1, "train_dir": str(tmp_path / "run"),
              "features": [{"features_dir": str(tmp_path / name), "truth": name == "pos",
                            "sampling_weight": 1.0, "penalty_weight": 1.0,
                            "truncation_strategy": "random", "type": "mmap"}
                           for name in ("pos", "neg")]}
    loop_s = []
    train_loop = T._train_loop

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return train_loop(*args, **kwargs)
        finally:
            loop_s.append(time.perf_counter() - t0)

    monkeypatch.setattr(T, "_train_loop", timed)
    _, history = T.train(_bundle(), config, FeatureHandler(config, "cpu"), device="cpu")
    (record,) = history
    assert math.isfinite(record["steps_per_sec"])
    assert record["steps_per_sec"] == pytest.approx(steps / loop_s[0], rel=0.2)
