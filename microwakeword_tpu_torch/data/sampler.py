"""On-device training-batch sampler for precomputed spectrograms (port of
data/sampler.py).

The whole training corpus lives on the card as one flat array of uint16
feature rows, and batch assembly -- weighted provider choice, clip choice,
truncation-window selection, left zero padding, uint16 -> float32 scaling and
SpecAugment -- runs there from draws of a ``torch.Generator`` on the same
device.  Nothing here waits for the card: no ``.item()``, no boolean-mask
indexing, no ``torch.nonzero``.

JAX's threefry streams cannot be reproduced in torch, so each draw is split
from what it drives: ``windows_from_draws`` and ``spec_augment_from_uniforms``
compute windows and masks from given values exactly as ``_draw_windows`` and
``apply_spec_augment`` do from their draws, and the wrappers here draw those
values from the generator.  The provider draw is Gumbel-max, which is what
``jax.random.categorical`` computes.

torch has no uint16 indexing on the card, so the corpus holds the store's
bits as int16 and ``windows_to_float`` reads them back as uint16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.frontend.constants import FEATURE_SCALE

MAX_CUTOFFS = 8

# Zero frames around the packed corpus, the total rounded to a multiple of
# WIDE_K: the JAX package's wide-row gather (WIDE_K frames per gathered row)
# relies on them.  The port gathers frame rows, but packs the same layout.
EDGE_PAD = 512
WIDE_K = 4

# truncation strategy ids
RANDOM, TRUNCATE_START, TRUNCATE_END, FIXED_RIGHT_CUTOFF = 0, 1, 2, 3
_STRATEGY_IDS = {
    "random": RANDOM,
    "truncate_start": TRUNCATE_START,
    "truncate_end": TRUNCATE_END,
    "fixed_right_cutoff": FIXED_RIGHT_CUTOFF,
    # eval-only strategies; training treats them as random
    "split": RANDOM,
    "none": RANDOM,
}


@dataclasses.dataclass(frozen=True)
class PackedTrainingData:
    """All training spectrograms and provider metadata as device tensors."""

    frames: torch.Tensor  # [total_frames, n_features] int16 (uint16 bits)
    clip_offset: torch.Tensor  # [n_clips] int32 frame offset
    clip_length: torch.Tensor  # [n_clips] int32
    provider_logits: torch.Tensor  # [P] f32 log sampling weight
    provider_clip_start: torch.Tensor  # [P] int32 index into clip_*
    provider_clip_count: torch.Tensor  # [P] int32
    provider_label: torch.Tensor  # [P] f32
    provider_penalty: torch.Tensor  # [P] f32
    provider_strategy: torch.Tensor  # [P] int32
    provider_cutoffs: torch.Tensor  # [P, MAX_CUTOFFS] int32
    provider_n_cutoffs: torch.Tensor  # [P] int32
    edge_pad: int = 0

    @property
    def device(self) -> torch.device:
        return self.frames.device


def frames_tensor(frames: np.ndarray) -> torch.Tensor:
    """uint16 feature rows (numpy) -> an int16 CPU tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(frames, np.uint16).view(np.int16))


def windows_to_float(windows: torch.Tensor) -> torch.Tensor:
    """int16 rows holding uint16 bits -> float32 values in [0, 65535]."""
    return (windows.to(torch.int32) & 0xFFFF).to(torch.float32)


def pack_training_arrays(providers, shard_index: int = 0, shard_count: int = 1) -> dict:
    """Concatenates every provider's training split into host numpy arrays
    keyed by PackedTrainingData field, in the JAX package's layout.

    Sharding keeps clips ``i % shard_count == shard_index`` of every store
    (one process: everything).
    """
    frames_parts, offsets, lengths = [], [], []
    p_logit, p_start, p_count, p_label, p_penalty, p_strategy = [], [], [], [], [], []
    p_cutoffs, p_ncut = [], []
    frame_pos = 0
    clip_pos = 0
    for p in providers:
        if getattr(p, "stores", None) is None:
            raise NotImplementedError(
                "providers without ragged stores (generated audio pools) are not "
                "ported yet: ROADMAP queue item 4, raw-audio and mixed training"
            )
        n_clips = 0
        for store in p.stores["training"]:
            if shard_count > 1:
                keep = np.arange(shard_index, len(store), shard_count)
                if len(keep) == 0:
                    continue
                clip_lens = np.diff(store.offsets)[keep]
                arr = np.concatenate([store.data[store.offsets[i] : store.offsets[i + 1]] for i in keep])
                offs = np.concatenate([[0], np.cumsum(clip_lens)])[:-1] + frame_pos
            else:
                arr = np.ascontiguousarray(store.data)
                clip_lens = np.diff(store.offsets)
                offs = np.asarray(store.offsets[:-1], np.int64) + frame_pos
            frames_parts.append(arr)
            offsets.append(offs)
            lengths.append(clip_lens)
            frame_pos += arr.shape[0]
            n_clips += len(clip_lens)
        if n_clips == 0:
            continue
        p_logit.append(np.log(p.sampling_weight) if p.sampling_weight > 0 else -1e30)
        p_start.append(clip_pos)
        p_count.append(n_clips)
        p_label.append(p.label)
        p_penalty.append(p.penalty_weight)
        p_strategy.append(_STRATEGY_IDS[p.truncation_strategy])
        cuts = list(p.fixed_right_cutoffs)[:MAX_CUTOFFS]
        p_cutoffs.append(cuts + [0] * (MAX_CUTOFFS - len(cuts)))
        p_ncut.append(len(cuts))
        clip_pos += n_clips
    if not frames_parts:
        raise ValueError("no training spectrograms found in any provider")
    total = sum(p.shape[0] for p in frames_parts)
    width = frames_parts[0].shape[1]
    dtype = frames_parts[0].dtype
    end_pad = EDGE_PAD + (-(EDGE_PAD + total)) % WIDE_K
    frames_parts = [np.zeros((EDGE_PAD, width), dtype)] + frames_parts + [np.zeros((end_pad, width), dtype)]
    return dict(
        frames=np.concatenate(frames_parts, axis=0),
        edge_pad=EDGE_PAD,
        clip_offset=(np.concatenate(offsets) + EDGE_PAD).astype(np.int32),
        clip_length=np.concatenate(lengths).astype(np.int32),
        provider_logits=np.asarray(p_logit, np.float32),
        provider_clip_start=np.asarray(p_start, np.int32),
        provider_clip_count=np.asarray(p_count, np.int32),
        provider_label=np.asarray(p_label, np.float32),
        provider_penalty=np.asarray(p_penalty, np.float32),
        provider_strategy=np.asarray(p_strategy, np.int32),
        provider_cutoffs=np.asarray(p_cutoffs, np.int32),
        provider_n_cutoffs=np.asarray(p_ncut, np.int32),
    )


def upload_training_arrays(arrays: dict, device=None) -> PackedTrainingData:
    """pack_training_arrays' dict -> PackedTrainingData on ``device``."""
    dev = resolve_device(device)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
               for k, v in arrays.items() if k not in ("frames", "edge_pad")}
    return PackedTrainingData(frames=frames_tensor(arrays["frames"]).to(dev),
                              edge_pad=int(arrays.get("edge_pad", 0)), **tensors)


def pack_training_data(providers, device=None, shard_index: int = 0,
                       shard_count: int = 1) -> PackedTrainingData:
    """pack_training_arrays uploaded to ``device`` (default the card)."""
    return upload_training_arrays(pack_training_arrays(providers, shard_index, shard_count), device)


def window_rows(off: torch.Tensor, n: torch.Tensor, start: torch.Tensor, length: int):
    """Row indices [B, length] of each window in the packed array (clamped
    to the clip) and the valid mask [B, length] of rows inside it."""
    rel = start[:, None] + torch.arange(length, device=start.device)[None, :]
    valid = (rel >= 0) & (rel < n[:, None])
    rows = off[:, None] + torch.minimum(torch.clamp(rel, min=0), (n - 1)[:, None])
    return rows, valid


def gather_windows(array: torch.Tensor, off: torch.Tensor, n: torch.Tensor,
                   start: torch.Tensor, length: int):
    """Gathers [B] windows of ``length`` rows from a packed ragged array.

    array [total_rows, W]; off/n [B] clip row offset and row count; start
    [B] window start relative to the clip (negative for short clips: leading
    silence).  Returns (windows [B, length, W] in array's dtype, valid
    [B, length] bool).
    """
    rows, valid = window_rows(off, n, start, length)
    windows = array.index_select(0, rows.reshape(-1)).reshape(rows.shape + array.shape[1:])
    return windows, valid


def _keep_mask(u_size: torch.Tensor, u_start: torch.Tensor, max_size: int, dim: int) -> torch.Tensor:
    """[B, dim] bool, False inside any of the [B, m] masks drawn from the
    uniforms: size floor(U * max), start floor(U * (dim - size + 1))."""
    size = torch.floor(u_size * max_size).to(torch.int32)
    start = torch.floor(u_start * (dim - size + 1).to(torch.float32)).to(torch.int32)
    iota = torch.arange(dim, device=u_size.device, dtype=torch.int32)
    outside = (iota < start[..., None]) | (iota >= (start + size)[..., None])
    return outside.all(dim=1)


def spec_augment_from_uniforms(feats: torch.Tensor, u_size: torch.Tensor, u_start: torch.Tensor,
                               time_mask_max_size: int, time_mask_count: int,
                               freq_mask_max_size: int, freq_mask_count: int) -> torch.Tensor:
    """SpecAugment of [B, T, F] features from [B, time_mask_count +
    freq_mask_count] uniforms per mask size and start, time masks first: the
    arithmetic of the JAX package's apply_spec_augment (reference data.py:32-71
    semantics).  One multiply by the union of the masks equals JAX's
    multiply per mask: the factors are 0 and 1 and the features >= 0."""
    t, f = feats.shape[1], feats.shape[2]
    tc = time_mask_count
    keep_t = _keep_mask(u_size[:, :tc], u_start[:, :tc], time_mask_max_size, t)
    keep_f = _keep_mask(u_size[:, tc:tc + freq_mask_count], u_start[:, tc:tc + freq_mask_count],
                        freq_mask_max_size, f)
    return feats * (keep_t[:, :, None] & keep_f[:, None, :])


def apply_spec_augment(generator: torch.Generator, feats: torch.Tensor, time_mask_max_size: int,
                       time_mask_count: int, freq_mask_max_size: int, freq_mask_count: int) -> torch.Tensor:
    """Per-sample SpecAugment with uniforms drawn from ``generator``."""
    m = time_mask_count + freq_mask_count
    u = torch.rand((feats.shape[0], 2 * m), generator=generator, device=feats.device)
    return spec_augment_from_uniforms(feats, u[:, :m], u[:, m:], time_mask_max_size,
                                      time_mask_count, freq_mask_max_size, freq_mask_count)


def windows_from_draws(data: PackedTrainingData, prov: torch.Tensor, u_clip: torch.Tensor,
                       u_win: torch.Tensor, u_cut: torch.Tensor, features_length: int):
    """Window placement from one step's draws: provider ids [B] and three
    [B] uniforms (clip, random start, fixed right cutoff).  Returns (off [B],
    n [B], start [B], labels [B], weights [B]) exactly as ``_draw_windows``
    of the JAX package computes them from the same values."""
    length = features_length
    count = data.provider_clip_count[prov]
    clip = data.provider_clip_start[prov] + torch.minimum(
        torch.floor(u_clip * count).to(torch.int32), count - 1)
    n = data.clip_length[clip]
    off = data.clip_offset[clip]

    strategy = data.provider_strategy[prov]
    # random: randint(0, n - L), high-exclusive (n > L in that branch)
    start_random = torch.floor(u_win * torch.clamp(n - length, min=1)).to(torch.int32)
    start_tstart = n - length
    ncut = data.provider_n_cutoffs[prov]
    cut_idx = torch.minimum(torch.floor(u_cut * ncut).to(torch.int32), ncut - 1)
    cutoff = data.provider_cutoffs[prov, cut_idx]
    start_cutoff = n - length - cutoff
    start_long = torch.where(
        strategy == RANDOM, start_random,
        torch.where(strategy == TRUNCATE_START, start_tstart,
                    torch.where(strategy == TRUNCATE_END, torch.zeros_like(n),
                                torch.where(strategy == FIXED_RIGHT_CUTOFF, start_cutoff,
                                            torch.zeros_like(n)))))
    # short clips: right-aligned with left zero padding (start may be negative)
    start = torch.where(n > length, start_long, n - length)
    return off, n, start, data.provider_label[prov], data.provider_penalty[prov]


def _draw_windows(data: PackedTrainingData, generator: torch.Generator, batch_size: int,
                  features_length: int):
    """The step's sampling draw: weighted provider choice (Gumbel-max),
    uniform clip, window start per truncation strategy (windows_from_draws)."""
    p = data.provider_logits.shape[0]
    u = torch.rand((batch_size, p + 3), generator=generator, device=data.device)
    prov = torch.argmax(data.provider_logits - torch.log(-torch.log(u[:, :p])), dim=1)
    return windows_from_draws(data, prov, u[:, p], u[:, p + 1], u[:, p + 2], features_length)


def sample_batch_indices(data: PackedTrainingData, generator: torch.Generator, batch_size: int,
                         features_length: int):
    """The index half of sample_batch: (rows [B, L] into data.frames, valid
    [B, L] bool, labels [B], weights [B])."""
    off, n, start, labels, weights = _draw_windows(data, generator, batch_size, features_length)
    rows, valid = window_rows(off, n, start, features_length)
    return rows, valid, labels, weights


def finish_batch(generator: torch.Generator | None, windows: torch.Tensor, valid: torch.Tensor,
                 time_mask_max_size: int = 0, time_mask_count: int = 0,
                 freq_mask_max_size: int = 0, freq_mask_count: int = 0) -> torch.Tensor:
    """Scaling and SpecAugment of gathered int16 windows: features [B, L, F]
    float32 in [0, 2560), zero outside the clip."""
    feats = windows_to_float(windows) * valid[:, :, None] * FEATURE_SCALE
    if time_mask_count or freq_mask_count:
        feats = apply_spec_augment(generator, feats, time_mask_max_size, time_mask_count,
                                   freq_mask_max_size, freq_mask_count)
    return feats


def sample_batch(data: PackedTrainingData, generator: torch.Generator, batch_size: int,
                 features_length: int, time_mask_max_size: int = 0, time_mask_count: int = 0,
                 freq_mask_max_size: int = 0, freq_mask_count: int = 0):
    """One training batch on the card: the draw (_draw_windows), the frame
    gather and finish_batch.  Returns (features [B, L, F] float32, labels
    [B], weights [B])."""
    off, n, start, labels, weights = _draw_windows(data, generator, batch_size, features_length)
    windows, valid = gather_windows(data.frames, off, n, start, features_length)
    feats = finish_batch(generator, windows, valid, time_mask_max_size, time_mask_count,
                         freq_mask_max_size, freq_mask_count)
    return feats, labels, weights
