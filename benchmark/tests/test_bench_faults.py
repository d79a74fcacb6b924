"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run (set-up, window, comparison against the
cell's own limits) on the CPU at a small size, without the look for a card,
with one fault planted in the program: a train step that leaves its state
unchanged, a loss over half of the batch, a batch whose windows are shifted
by a frame (which only the sampler's stage can see: the model's stage is
judged on the features the model was given), a streamed probability or an
accept count altered where it is produced.  The exchange between chips does
not exist in these one-card cells.  A sound run of each cell beside them
comes out correct."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark.lib.cell import load_cell
from benchmark.run import run_cell

from conftest import shrink

CPU = torch.device("cpu")


def _run(name: str):
    cell = shrink(load_cell(name, seed=2**31 + 5, seconds=0.5))
    return run_cell(cell, CPU, time.perf_counter())


def _state_unchanged(monkeypatch):
    from microwakeword_tpu_torch.train import loop

    monkeypatch.setattr(loop.TrainStep, "_adam", lambda self, learning_rate: None)


def _half_batch(monkeypatch):
    from microwakeword_tpu_torch.train import loop

    full = loop.weighted_bce

    def half(probs, labels, weights):
        n = probs.shape[0] // 2
        return full(probs[:n], labels[:n], weights[:n])

    monkeypatch.setattr(loop, "weighted_bce", half)


def _window_shifted(monkeypatch):
    from microwakeword_tpu_torch.data import sampler

    sample = sampler.sample_any

    def shifted(*args, **kwargs):
        feats, labels, penalties = sample(*args, **kwargs)
        return feats.roll(1, dims=1), labels, penalties

    monkeypatch.setattr(sampler, "sample_any", shifted)


def _probability_altered(monkeypatch):
    from microwakeword_tpu_torch.models.registry import ModelBundle

    scan = ModelBundle.stream_scan

    def altered(self, model, x, cache=None):
        probs = scan(self, model, x, cache).clone()
        at = probs[0, probs.shape[1] // 2, 0]
        probs[0, probs.shape[1] // 2, 0] = 1.0 if at < 0.5 else 0.0
        return probs

    monkeypatch.setattr(ModelBundle, "stream_scan", altered)


def _count_altered(monkeypatch):
    from microwakeword_tpu_torch.evaluate import roc

    count = roc.count_accepts

    def altered(probs, cutoffs, ignore_slices_after_accept):
        counts = count(probs, cutoffs, ignore_slices_after_accept).clone()
        counts[..., 0] += 1
        return counts

    monkeypatch.setattr(roc, "count_accepts", altered)


def _clip_answer_altered(monkeypatch):
    from microwakeword_tpu_torch.inference import Model

    predict = Model.predict_clip

    def altered(self, audio, step_ms=10):
        probs = np.array(predict(self, audio, step_ms))
        probs[-1] = 1.0 if probs[-1] < 0.5 else 0.0
        return probs

    monkeypatch.setattr(Model, "predict_clip", altered)


FAULTS = [
    ("mixednet-train-rawaudio", _state_unchanged),
    ("mixednet-train-rawaudio", _half_batch),
    ("mixednet-train-rawaudio", _window_shifted),
    ("mixednet-score-64x10s", _probability_altered),
    ("mixednet-score-64x10s", _count_altered),
    ("mixednet-clip-1to3s", _clip_answer_altered),
]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(name)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", ["mixednet-train-rawaudio", "mixednet-score-64x10s",
                                  "mixednet-clip-1to3s"])
def test_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
