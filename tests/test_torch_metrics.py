"""The port's validation metrics against the JAX package's, on identical
probability arrays: ``binary_metrics`` (ties included, AUC ranked by a stable
sort), ``confusion_at_cutoffs``, ``validation_metrics`` in both branches
(interpolated recall at 2 faph or not) and ``is_new_best``.  Counts, rates
and the AUC are equal; the BCE loss agrees to 1e-6 relative (log and log1p
of two libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microwakeword_tpu.train import metrics as JM
from microwakeword_tpu_torch.train import metrics as M

torch.set_num_threads(2)


def _probs(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    labels = (rng.uniform(size=n) < 0.4).astype(np.float32)
    if kind == "ties":  # few distinct values, shared by positives and negatives
        probs = rng.choice(np.array([0.0, 0.2, 0.5, 0.7, 1.0], np.float32), n)
    else:
        probs = np.clip(rng.normal(0.3 + 0.4 * labels, 0.25), 0.0, 1.0).astype(np.float32)
    return probs, labels


@pytest.mark.parametrize("kind", ["ties", "continuous"])
@pytest.mark.parametrize("n", [7, 200])
def test_binary_metrics_match_jax(kind, n):
    probs, labels = _probs(kind, n, n)
    want = {k: float(v) for k, v in JM.binary_metrics(jnp.asarray(probs), jnp.asarray(labels)).items()}
    got = {k: float(v) for k, v in M.binary_metrics(torch.from_numpy(probs), torch.from_numpy(labels)).items()}
    assert set(got) == set(want)
    for key in ("accuracy", "recall", "precision", "auc"):
        assert got[key] == want[key], key
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)


def test_binary_metrics_all_one_class():
    probs = np.array([0.1, 0.9, 0.6], np.float32)
    for labels in (np.zeros(3, np.float32), np.ones(3, np.float32)):
        want = JM.binary_metrics(jnp.asarray(probs), jnp.asarray(labels))
        got = M.binary_metrics(torch.from_numpy(probs), torch.from_numpy(labels))
        for key in ("accuracy", "recall", "precision", "auc"):
            assert float(got[key]) == float(want[key]), key


def test_confusion_at_cutoffs_matches_jax():
    probs, labels = _probs("ties", 64, 3)
    probs[:5] = [0.01, 0.29, 0.3, 0.71, 0.99]  # on the cutoff grid
    weights = np.random.default_rng(3).uniform(0.5, 2.0, 64).astype(np.float32)
    for w in (None, weights):
        want = JM.confusion_at_cutoffs(jnp.asarray(probs), jnp.asarray(labels),
                                       None if w is None else jnp.asarray(w))
        got = M.confusion_at_cutoffs(torch.from_numpy(probs), torch.from_numpy(labels),
                                     None if w is None else torch.from_numpy(w))
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, err_msg=key)


def _validation_case(branch: str, seed: int):
    rng = np.random.default_rng(seed)
    val_probs, val_labels = _probs("continuous", 120, seed)
    if branch == "interpolated":  # faph at cutoff 0 above 2: many ambient false accepts
        ambient = rng.uniform(0.0, 0.6, 400).astype(np.float32)
    else:
        ambient = rng.uniform(0.0, 0.35, 3).astype(np.float32)
    return val_probs, val_labels, ambient


@pytest.mark.parametrize("branch", ["interpolated", "direct"])
@pytest.mark.parametrize("seed", [0, 1])
def test_validation_metrics_match_jax(branch, seed):
    val_probs, val_labels, ambient = _validation_case(branch, seed)
    want = JM.validation_metrics(val_probs, val_labels, ambient, ambient_duration_hours=2.5)
    got = M.validation_metrics(val_probs, val_labels, ambient, ambient_duration_hours=2.5)
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "loss":
            assert got[key] == pytest.approx(value, rel=1e-6)
        else:
            assert got[key] == value, key
    assert (want["ambient_false_positives_per_hour"] > 0) == (branch == "interpolated")


def test_validation_metrics_without_ambient_match_jax():
    val_probs, val_labels, _ = _validation_case("direct", 4)
    for ambient in (None, np.zeros((0,), np.float32)):
        want = JM.validation_metrics(val_probs, val_labels, ambient, 1.0)
        got = M.validation_metrics(val_probs, val_labels, ambient, 1.0)
        assert {k: v for k, v in got.items() if k != "loss"} == {
            k: v for k, v in want.items() if k != "loss"}


def test_is_new_best_matches_jax():
    values = [0.0, 0.3, 0.5, 0.9, 10000.0]
    for current_min in values:
        for current_max in (0.0, 0.4, 0.8):
            for best_min in values:
                for best_max in (0.0, 0.4, 0.8):
                    args = (current_min, current_max, best_min, best_max, 0.5)
                    assert M.is_new_best(*args) == JM.is_new_best(*args), args
