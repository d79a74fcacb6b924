"""Feature store: loads ragged spectrogram sets and serves batches (port of
data/store.py).

Host-side equivalent of the reference FeatureHandler with the same YAML
schema and sampling semantics.  ``get_data`` assembles evaluation sets on the
host; training batches are drawn on the card from the corpus that
``pack_training`` (spectrograms) or ``pack_training_audio`` (raw audio, the
in-step frontend) uploads (``data/sampler.py``).  ``type: mmap`` feature sets
read ragged stores from disk; ``type: clips`` sets generate augmented audio
from WAV clips (``ClipsFeatureSet``).
"""

from __future__ import annotations

import os
import random
from pathlib import Path

import numpy as np

from microwakeword_tpu_torch import native
from microwakeword_tpu_torch.audio.augmentation import Augmentation
from microwakeword_tpu_torch.audio.clips import Clips
from microwakeword_tpu_torch.audio.spectrograms import SpectrogramGeneration
from microwakeword_tpu_torch.data.ragged_store import open_ragged
from microwakeword_tpu_torch.data.sampler import pack_mixed_data, pack_training_data
from microwakeword_tpu_torch.frontend import constants as FC

MODES = ("training", "validation", "testing", "validation_ambient", "testing_ambient")

FEATURE_SCALE = np.float32(FC.FEATURE_SCALE)

TRUNCATION_STRATEGIES = (
    "random", "truncate_start", "truncate_end", "fixed_right_cutoff", "split", "none",
)


def spec_augment(spectrogram: np.ndarray, time_mask_max_size: int = 0, time_mask_count: int = 0,
                 freq_mask_max_size: int = 0, freq_mask_count: int = 0,
                 rng: np.random.Generator | None = None) -> np.ndarray:
    """SpecAugment masks (reference data.py:32-71 semantics)."""
    rng = rng or np.random.default_rng()
    out = np.copy(spectrogram)
    t_frames, f_bins = out.shape
    for _ in range(time_mask_count):
        t = int(rng.uniform(0, time_mask_max_size))
        t0 = rng.integers(0, t_frames - t + 1)
        out[t0 : t0 + t, :] = 0
    for _ in range(freq_mask_count):
        f = int(rng.uniform(0, freq_mask_max_size))
        f0 = rng.integers(0, f_bins - f + 1)
        out[:, f0 : f0 + f] = 0
    return out


def fixed_length_spectrogram(spectrogram: np.ndarray, features_length: int,
                             truncation_strategy: str = "random", right_cutoff: int = 0,
                             rng: np.random.Generator | None = None) -> np.ndarray:
    """Pad (left zeros) or truncate to features_length (reference data.py:74-118)."""
    rng = rng or np.random.default_rng()
    n = spectrogram.shape[0]
    offset = 0
    if n > features_length:
        if truncation_strategy == "random":
            # the reference's randint(0, n - L) is high-exclusive
            offset = int(rng.integers(0, n - features_length))
        elif truncation_strategy == "none":
            return spectrogram
        elif truncation_strategy == "truncate_start":
            offset = n - features_length
        elif truncation_strategy == "truncate_end":
            offset = 0
        elif truncation_strategy == "fixed_right_cutoff":
            offset = n - features_length - right_cutoff
        else:
            raise ValueError(f"unknown truncation strategy {truncation_strategy!r}")
    else:
        spectrogram = np.pad(spectrogram, ((features_length - n, 0), (0, 0)), constant_values=0)
    return spectrogram[offset : offset + features_length]


def _scale(spec: np.ndarray) -> np.ndarray:
    if np.issubdtype(spec.dtype, np.uint16):
        return spec.astype(np.float32) * FEATURE_SCALE
    return spec.astype(np.float32)


def gather_windows(data: np.ndarray, offsets: np.ndarray, clip_idx: np.ndarray,
                   starts: np.ndarray, length: int) -> np.ndarray:
    """[B, length, F] float32 windows of a ragged uint16 store, scaled by
    FEATURE_SCALE and zero outside each clip (``starts`` relative to the
    clip, negative for left padding).  The plain version of the native
    threaded gather (``native.gather_windows``, which ``gather_mode`` runs),
    equal to it bit for bit: u * 0.0390625 is exact in float32 for every
    uint16 u."""
    clip_idx = np.asarray(clip_idx, np.int64)
    begin = np.asarray(offsets, np.int64)[clip_idx]
    n = np.asarray(offsets, np.int64)[clip_idx + 1] - begin
    rel = np.asarray(starts, np.int64)[:, None] + np.arange(length)[None, :]
    valid = (rel >= 0) & (rel < n[:, None])
    rows = begin[:, None] + np.clip(rel, 0, np.maximum(n - 1, 0)[:, None])
    rows = np.minimum(rows, len(data) - 1)  # an empty last clip reads nothing
    out = np.asarray(data)[rows].astype(np.float32) * FEATURE_SCALE
    out[~valid] = 0.0
    return out


class MmapFeatureSet:
    """One configured feature set backed by ragged stores on disk
    (reference MmapFeatureGenerator, data.py:121-321)."""

    def __init__(self, features_dir: str, truth: bool, sampling_weight: float,
                 penalty_weight: float, truncation_strategy: str, stride: int = 1,
                 step_ms: int = 10, fixed_right_cutoffs: list[int] | None = None):
        self.label = float(truth)
        self.sampling_weight = float(sampling_weight)
        self.penalty_weight = float(penalty_weight)
        self.truncation_strategy = truncation_strategy
        self.fixed_right_cutoffs = fixed_right_cutoffs or [0]
        self.stride = stride
        self.step_s = step_ms / 1000.0

        self.stores: dict[str, list] = {m: [] for m in MODES}
        self.stats: dict[str, dict] = {}
        for mode in MODES:
            count, duration = 0, 0.0
            mode_dir = os.path.join(features_dir, mode)
            for p in sorted(Path(os.path.abspath(mode_dir)).glob("**/*_mmap")):
                if not p.is_dir():
                    continue
                store = open_ragged(str(p))
                self.stores[mode].append(store)
                count += len(store)
                duration += self.step_s * float(np.sum(np.diff(store.offsets)))
            self.stats[mode] = {"spectrogram_count": count, "total_duration": duration}

    def get_mode_size(self, mode: str) -> int:
        return self.stats[mode]["spectrogram_count"]

    def get_mode_duration(self, mode: str) -> float:
        return self.stats[mode]["total_duration"]

    def _all(self, mode: str):
        for store in self.stores[mode]:
            yield from store

    def get_random_spectrogram(self, mode, features_length, truncation_strategy, rng=None):
        rng = rng or np.random.default_rng()
        if truncation_strategy == "default":
            truncation_strategy = self.truncation_strategy
        right_cutoff = 0
        if truncation_strategy == "fixed_right_cutoff":
            right_cutoff = random.choice(self.fixed_right_cutoffs)
        sizes = [len(s) for s in self.stores[mode]]
        i = int(rng.integers(0, sum(sizes)))
        for store, size in zip(self.stores[mode], sizes):
            if i < size:
                spec = store[i]
                break
            i -= size
        return _scale(fixed_length_spectrogram(
            spec, features_length, truncation_strategy, right_cutoff, rng))

    def feature_generator(self, mode, features_length, truncation_strategy="default"):
        """Deterministic pass over a mode (reference data.py:273-321)."""
        if truncation_strategy == "default":
            truncation_strategy = self.truncation_strategy
        for spec in self._all(mode):
            spec_f = _scale(spec)
            if truncation_strategy == "split":
                step_slices = int(1000 * self.step_s * self.stride)
                for start in range(0, spec_f.shape[0] - features_length, step_slices):
                    yield spec_f[start : start + features_length]
            else:
                for cutoff in self.fixed_right_cutoffs:
                    yield fixed_length_spectrogram(spec_f, features_length, truncation_strategy, cutoff)

    def gather_mode(self, mode, features_length, truncation_strategy="default") -> np.ndarray | None:
        """Vectorized equivalent of list(feature_generator(...)) by the
        native threaded gather (``native.gather_windows``), as in the JAX
        package.  Returns [N, features_length, 40] float32, or None where it
        does not apply (non-uint16 store, the 'none' and 'random'
        strategies); callers then use feature_generator."""
        if truncation_strategy == "default":
            truncation_strategy = self.truncation_strategy
        if truncation_strategy in ("none", "random"):
            return None
        outs = []
        for store in self.stores[mode]:
            if store.dtype != np.uint16:
                return None
            lengths = np.diff(store.offsets).astype(np.int64)
            clip_idx, starts = [], []
            if truncation_strategy == "split":
                step_slices = int(1000 * self.step_s * self.stride)
                for ci, n in enumerate(lengths):
                    # range(0, n - L, step): excludes the final window start
                    n_win = max(0, -(-(int(n) - features_length) // step_slices))
                    clip_idx.extend([ci] * n_win)
                    starts.extend(w * step_slices for w in range(n_win))
            else:
                for ci, n in enumerate(lengths):
                    n = int(n)
                    for cutoff in self.fixed_right_cutoffs:
                        if n > features_length:
                            if truncation_strategy == "truncate_start":
                                s = n - features_length
                            elif truncation_strategy == "truncate_end":
                                s = 0
                            elif truncation_strategy == "fixed_right_cutoff":
                                s = n - features_length - cutoff
                            else:
                                return None
                        else:
                            s = n - features_length  # <= 0: left zero-pad
                        clip_idx.append(ci)
                        starts.append(s)
            outs.append(native.gather_windows(store.data, store.offsets,
                                              np.asarray(clip_idx, np.int32),
                                              np.asarray(starts, np.int32), features_length,
                                              scale=float(FEATURE_SCALE)))
        if not outs:
            return np.zeros((0, features_length, 40), np.float32)
        return np.concatenate(outs, axis=0)


class ClipsFeatureSet:
    """On-the-fly feature set: freshly augmented audio from WAV clips
    (reference ClipsHandlerWrapperGenerator, data.py:324-402).  Training only;
    every other mode is empty.

    The on-device sampler needs the corpus on the card, so a pool of
    ``pack_pool_size`` augmented clips is materialized at pack time: raw audio
    for raw-audio training (``generate_audio_pool``), spectrograms otherwise
    (``generate_pool``).  The host-side ``get_random_spectrogram`` draws a
    fresh augmentation per sample, as the reference does.
    """

    stores = None  # marker: no ragged stores on disk

    def __init__(self, clips_settings: dict, augmentation_settings: dict,
                 spectrogram_generation_settings: dict, truth: bool, sampling_weight: float,
                 penalty_weight: float, truncation_strategy: str, pack_pool_size: int = 2000,
                 device=None):
        self.label = float(truth)
        self.sampling_weight = float(sampling_weight)
        self.penalty_weight = float(penalty_weight)
        self.truncation_strategy = truncation_strategy
        self.fixed_right_cutoffs = [0]
        self.pack_pool_size = int(pack_pool_size)
        self.spectrogram_generation = SpectrogramGeneration(
            Clips(**clips_settings), Augmentation(**augmentation_settings),
            **spectrogram_generation_settings, device=device)
        self._generator = self.spectrogram_generation.spectrogram_generator(random=True)

    def get_mode_size(self, mode: str) -> int:
        return len(self.spectrogram_generation.clips.clips) if mode == "training" else 0

    def get_mode_duration(self, mode: str) -> float:
        return 0.0

    def get_random_spectrogram(self, mode, features_length, truncation_strategy, rng=None):
        if truncation_strategy == "default":
            truncation_strategy = self.truncation_strategy
        return _scale(fixed_length_spectrogram(
            next(self._generator), features_length, truncation_strategy, 0, rng))

    def feature_generator(self, mode, features_length, truncation_strategy="default"):
        """Training-only provider: deterministic passes yield nothing
        (reference data.py:395-402)."""
        return iter(())

    def gather_mode(self, mode, features_length, truncation_strategy="default"):
        return None

    def _pool_size(self, shard_count: int) -> int:
        return max(1, self.pack_pool_size // max(1, shard_count))

    def _audio_pool(self, n: int) -> list[np.ndarray]:
        """n freshly augmented raw clips (float32 in [-1, 1])."""
        sg = self.spectrogram_generation
        gen = sg.clips.random_audio_generator()
        if sg.augmenter is not None:
            gen = sg.augmenter.augment_generator(gen)
        return [np.asarray(next(gen), np.float32) for _ in range(n)]

    def generate_audio_pool(self, shard_index: int = 0, shard_count: int = 1) -> list[np.ndarray]:
        """This shard's raw augmented clips for ``sampler.pack_audio_data``:
        the train step computes their features on the card."""
        return self._audio_pool(self._pool_size(shard_count))

    def generate_pool(self, shard_index: int = 0, shard_count: int = 1, device=None):
        """This shard's sampler pool of spectrograms: (frames uint16
        [sum(T_i), 40], lengths int64 [n]), the clips through the batched
        frontend on ``device`` (None: the card)."""
        specs = list(self.spectrogram_generation.batched_spectrograms(
            self._audio_pool(self._pool_size(shard_count)), device, batch=64))
        lengths = np.asarray([s.shape[0] for s in specs], np.int64)
        return np.concatenate(specs, axis=0), lengths


class FeatureHandler:
    """Loads all configured feature sets (reference FeatureHandler,
    data.py:405-597); the config schema is the reference YAML's.  ``device``
    (None: the card) runs the frontend of clips-type sets' host-side draws
    (``get_data("training")``)."""

    def __init__(self, config: dict, device=None):
        self.providers: list = []
        stride = config.get("stride", 1)
        step_ms = config.get("window_step_ms", 10)
        for fs in config.get("features", []):
            kind = fs.get("type", "mmap")
            if kind == "mmap":
                self.providers.append(MmapFeatureSet(
                    fs["features_dir"], fs["truth"], fs["sampling_weight"], fs["penalty_weight"],
                    fs["truncation_strategy"], stride=stride, step_ms=step_ms,
                    fixed_right_cutoffs=fs.get("fixed_right_cutoffs"),
                ))
            elif kind == "clips":
                self.providers.append(ClipsFeatureSet(
                    fs["clips_settings"], fs.get("augmentation_settings", {}),
                    fs.get("spectrogram_generation_settings", {}), fs["truth"],
                    fs["sampling_weight"], fs["penalty_weight"], fs["truncation_strategy"],
                    pack_pool_size=fs.get("pack_pool_size", 2000), device=device,
                ))
            else:
                raise NotImplementedError(f"feature set type {kind!r} not supported")

    def get_mode_size(self, mode: str) -> int:
        return sum(p.get_mode_size(mode) for p in self.providers)

    def get_mode_duration(self, mode: str) -> float:
        return sum(p.get_mode_duration(mode) for p in self.providers)

    def get_data(self, mode: str, batch_size: int, features_length: int,
                 truncation_strategy: str = "default", augmentation_policy: dict | None = None,
                 rng: np.random.Generator | None = None):
        """Host-side batch assembly with reference semantics (data.py:497-597):
        evaluation sets, and the golden model of the on-device sampler."""
        rng = rng or np.random.default_rng()
        policy = augmentation_policy or {}
        data, labels, weights = [], [], []
        if mode == "training":
            active = [p for p in self.providers if p.get_mode_size("training")]
            probs = np.asarray([p.sampling_weight for p in active], dtype=np.float64)
            probs = probs / probs.sum()
            choices = rng.choice(len(active), size=batch_size, p=probs)
            for ci in choices:
                p = active[ci]
                spec = p.get_random_spectrogram("training", features_length, truncation_strategy, rng)
                spec = spec_augment(
                    spec, policy.get("time_mask_max_size", 0), policy.get("time_mask_count", 0),
                    policy.get("freq_mask_max_size", 0), policy.get("freq_mask_count", 0), rng,
                )
                data.append(spec)
                labels.append(p.label)
                weights.append(p.penalty_weight)
        else:
            # per-provider blocks, in provider order for the labels and weights
            blocks = []
            for p in self.providers:
                fast = (p.gather_mode(mode, features_length, truncation_strategy)
                        if truncation_strategy != "none" else None)
                if fast is None:
                    slow = list(p.feature_generator(mode, features_length, truncation_strategy))
                    if truncation_strategy == "none":
                        data.extend(slow)
                        fast = slow  # only for the label/weight count below
                    else:
                        fast = (np.stack(slow).astype(np.float32) if slow
                                else np.zeros((0, features_length, 40), np.float32))
                        blocks.append(fast)
                else:
                    blocks.append(fast)
                labels.extend([p.label] * len(fast))
                weights.extend([p.penalty_weight] * len(fast))

        labels = np.asarray(labels, dtype=np.float32)
        weights = np.asarray(weights, dtype=np.float32)
        if truncation_strategy == "none":
            return data, labels, weights
        if mode == "training":
            data = (np.stack(data).astype(np.float32) if data
                    else np.zeros((0, features_length, 40), np.float32))
        else:
            data = (np.concatenate(blocks, axis=0) if blocks
                    else np.zeros((0, features_length, 40), np.float32))
        # the reference shuffles every non-"none" result (data.py:591-597)
        idx = rng.permutation(len(labels))
        return data[idx], labels[idx], weights[idx]

    def pack_training(self, device=None, shard_index: int = 0, shard_count: int = 1):
        """Every training split on ``device`` (default the card) for the
        on-device sampler (``data/sampler.py``); clips-type sets contribute a
        pool of spectrograms computed on ``device``."""
        return pack_training_data(self.providers, device, shard_index, shard_count)

    def pack_training_audio(self, device=None, shard_index: int = 0, shard_count: int = 1,
                            step_ms: int = 10):
        """Packs for in-step frontend training (config ``raw_audio_training:
        true``): clips-type sets contribute raw augmented audio, mmap sets
        precomputed spectrograms, so a mixed config (e.g. generated positives
        and precomputed negatives, the reference's usual recipe,
        data.py:405-466) trains on one step through ``PackedMixedData``.
        ``step_ms`` is the frontend hop (config window_step_ms)."""
        return pack_mixed_data(self.providers, device, shard_index, shard_count, step_ms)
