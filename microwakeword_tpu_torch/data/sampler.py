"""On-device training-batch sampler (port of data/sampler.py).

The whole training corpus lives on the card: precomputed spectrograms as one
flat array of uint16 feature rows (``PackedTrainingData``), raw augmented
audio as int16 hop chunks (``PackedAudioData``), or both
(``PackedMixedData``).  Batch assembly -- weighted provider choice, clip
choice, truncation-window selection, left zero padding, uint16 -> float32
scaling or the frontend kernel on the gathered audio, and SpecAugment -- runs
there from draws of a ``torch.Generator`` on the same device.  Nothing here
waits for the card: no ``.item()``, no boolean-mask indexing, no
``torch.nonzero``.

JAX's threefry streams cannot be reproduced in torch, so each draw is split
from what it drives: ``windows_from_draws``, ``audio_windows_from_draws`` and
``spec_augment_from_uniforms`` compute windows and masks from given values
exactly as the JAX package does from its draws, and the wrappers here draw
those values from the generator.  The provider draw is Gumbel-max, which is what
``jax.random.categorical`` computes.

The wrappers take ``rows``, a slice of the batch: every uniform is drawn for
the whole ``batch_size``-row batch, and only the rows of the slice are
gathered and computed.  One rank of a data-parallel mesh draws its block of
the batch so (``parallel/train_step.py``): the rows it computes are the solo
step's, and its generator stays in step with every other rank's.

torch has no uint16 indexing on the card, so the corpus holds the store's
bits as int16 and ``windows_to_float`` reads them back as uint16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.frontend import constants as FC
from microwakeword_tpu_torch.frontend.constants import FEATURE_SCALE
from microwakeword_tpu_torch.frontend.kernel import frontend_batch

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


def pack_training_arrays(providers, shard_index: int = 0, shard_count: int = 1,
                         device=None) -> dict:
    """Concatenates every provider's training split into host numpy arrays
    keyed by PackedTrainingData field, in the JAX package's layout.

    Sharding keeps clips ``i % shard_count == shard_index`` of every store
    (one process: everything).  A provider without stores (``ClipsFeatureSet``)
    contributes its shard of a freshly augmented pool of spectrograms,
    computed by the frontend on ``device`` (None: the card).
    """
    frames_parts, offsets, lengths = [], [], []
    p_logit, p_start, p_count, p_label, p_penalty, p_strategy = [], [], [], [], [], []
    p_cutoffs, p_ncut = [], []
    frame_pos = 0
    clip_pos = 0
    for p in providers:
        n_clips = 0
        if getattr(p, "stores", None) is None:
            arr, clip_lens = p.generate_pool(shard_index, shard_count, device)
            if len(clip_lens):
                frames_parts.append(arr)
                offsets.append(np.concatenate([[0], np.cumsum(clip_lens)])[:-1] + frame_pos)
                lengths.append(clip_lens)
                frame_pos += arr.shape[0]
                n_clips += len(clip_lens)
        for store in (p.stores or {}).get("training", []):
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
    return upload_training_arrays(
        pack_training_arrays(providers, shard_index, shard_count, device), device)


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
                       time_mask_count: int, freq_mask_max_size: int, freq_mask_count: int,
                       batch_size: int | None = None, rows: slice | None = None) -> torch.Tensor:
    """Per-sample SpecAugment with uniforms drawn from ``generator``: a draw
    for ``batch_size`` rows (default feats' rows), of which ``rows`` are
    feats'."""
    m = time_mask_count + freq_mask_count
    n = feats.shape[0] if batch_size is None else batch_size
    u = torch.rand((n, 2 * m), generator=generator, device=feats.device)
    if rows is not None:
        u = u[rows]
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


def window_uniforms(data: PackedTrainingData, generator: torch.Generator,
                    batch_size: int) -> torch.Tensor:
    """The step's sampling draw: [B, P + 3] uniforms from ``generator`` (P
    for the provider's Gumbel-max, then clip, random start, cutoff)."""
    p = data.provider_logits.shape[0]
    return torch.rand((batch_size, p + 3), generator=generator, device=data.device)


def windows_from_uniforms(data: PackedTrainingData, u: torch.Tensor, features_length: int):
    """Window placement from ``window_uniforms``' [B, P + 3] draw: weighted
    provider choice (Gumbel-max), uniform clip, window start per truncation
    strategy (windows_from_draws)."""
    p = data.provider_logits.shape[0]
    prov = torch.argmax(data.provider_logits - torch.log(-torch.log(u[:, :p])), dim=1)
    return windows_from_draws(data, prov, u[:, p], u[:, p + 1], u[:, p + 2], features_length)


def _draw_windows(data: PackedTrainingData, generator: torch.Generator, batch_size: int,
                  features_length: int, rows: slice | None = None):
    u = window_uniforms(data, generator, batch_size)
    return windows_from_uniforms(data, u if rows is None else u[rows], features_length)


def sample_batch_indices(data: PackedTrainingData, generator: torch.Generator, batch_size: int,
                         features_length: int):
    """The index half of sample_batch: (rows [B, L] into data.frames, valid
    [B, L] bool, labels [B], weights [B])."""
    off, n, start, labels, weights = _draw_windows(data, generator, batch_size, features_length)
    rows, valid = window_rows(off, n, start, features_length)
    return rows, valid, labels, weights


def finish_batch(generator: torch.Generator | None, windows: torch.Tensor, valid: torch.Tensor,
                 time_mask_max_size: int = 0, time_mask_count: int = 0,
                 freq_mask_max_size: int = 0, freq_mask_count: int = 0,
                 batch_size: int | None = None, rows: slice | None = None) -> torch.Tensor:
    """Scaling and SpecAugment of gathered int16 windows: features [B, L, F]
    float32 in [0, 2560), zero outside the clip.  The windows are ``rows``
    of a ``batch_size``-row batch where given (apply_spec_augment)."""
    feats = windows_to_float(windows) * valid[:, :, None] * FEATURE_SCALE
    if time_mask_count or freq_mask_count:
        feats = apply_spec_augment(generator, feats, time_mask_max_size, time_mask_count,
                                   freq_mask_max_size, freq_mask_count, batch_size, rows)
    return feats


def sample_batch(data: PackedTrainingData, generator: torch.Generator, batch_size: int,
                 features_length: int, time_mask_max_size: int = 0, time_mask_count: int = 0,
                 freq_mask_max_size: int = 0, freq_mask_count: int = 0,
                 rows: slice | None = None):
    """One training batch on the card: the draw (_draw_windows), the frame
    gather and finish_batch.  Returns (features [B, L, F] float32, labels
    [B], weights [B]), or the ``rows`` of them."""
    off, n, start, labels, weights = _draw_windows(data, generator, batch_size, features_length,
                                                   rows)
    windows, valid = gather_windows(data.frames, off, n, start, features_length)
    feats = finish_batch(generator, windows, valid, time_mask_max_size, time_mask_count,
                         freq_mask_max_size, freq_mask_count, batch_size, rows)
    return feats, labels, weights


# ---- raw-audio training: the frontend inside the step -----------------------

HOP_SAMPLES = 160  # 10 ms at 16 kHz (the default window_step_ms=10 hop)


def window_chunks_for_hop(hop_samples: int) -> int:
    """Chunk rows a 480-sample frontend window spans (ceil): 3 at the 10 ms
    hop (exact), 2 at the 20 ms hop (640 gathered, 480 used)."""
    return -(-FC.WINDOW_SAMPLES // hop_samples)


@dataclasses.dataclass(frozen=True)
class PackedAudioData:
    """Raw-audio training corpus on the card, hop-aligned.

    Audio is stored as [total_chunks, hop_samples] int16, one row per feature
    hop (160 samples at the 10 ms step, 320 at 20 ms); every clip is
    zero-padded to whole chunks, so a window is a gather of chunk rows.  The
    train step samples windows from here and runs the frontend kernel on them
    (reference ClipsHandlerWrapperGenerator, data.py:324-402, in the JAX
    package's layout).
    """

    chunks: torch.Tensor  # [total_chunks, hop_samples] int16
    clip_offset: torch.Tensor  # [n_clips] int32 chunk offset
    clip_chunks: torch.Tensor  # [n_clips] int32 chunk count
    provider_logits: torch.Tensor  # [P] f32
    provider_clip_start: torch.Tensor  # [P] int32
    provider_clip_count: torch.Tensor  # [P] int32
    provider_label: torch.Tensor  # [P] f32
    provider_penalty: torch.Tensor  # [P] f32
    provider_strategy: torch.Tensor  # [P] int32
    hop_samples: int = HOP_SAMPLES
    edge_pad: int = 0

    @property
    def device(self) -> torch.device:
        return self.chunks.device


def clip_to_int16(clip: np.ndarray) -> np.ndarray:
    """A float [-1, 1] clip -> int16 by round(clip(x * 32768)); int16 as is."""
    clip = np.asarray(clip)
    if clip.dtype == np.int16:
        return clip
    return np.round(np.clip(clip * 32768.0, -32768.0, 32767.0)).astype(np.int16)


def pack_audio_data(providers, device=None, shard_index: int = 0, shard_count: int = 1,
                    step_ms: int = 10) -> PackedAudioData:
    """Packs the providers' raw augmented audio pools into chunk rows on
    ``device`` (None: the card), in the JAX package's layout: EDGE_PAD zero
    chunks before the first clip and after the last, the total a multiple of
    WIDE_K, every clip at least one frontend window long.

    Every provider must have ``generate_audio_pool(shard_index, shard_count)``
    (float [-1, 1] or int16 clips; ``ClipsFeatureSet`` has it).  ``step_ms``
    (config window_step_ms) sets the chunk width, 16 * step_ms samples.
    """
    dev = resolve_device(device)
    hop = 16 * int(step_ms)
    min_chunks = window_chunks_for_hop(hop)
    chunk_parts, offsets, counts = [], [], []
    p_logit, p_start, p_count, p_label, p_penalty, p_strategy = [], [], [], [], [], []
    chunk_pos = EDGE_PAD
    clip_pos = 0
    for p in providers:
        if not hasattr(p, "generate_audio_pool"):
            raise ValueError(
                f"provider {type(p).__name__} has no raw audio (generate_audio_pool); "
                "raw-audio training requires clips-type feature sets")
        n_clips = 0
        for clip in p.generate_audio_pool(shard_index, shard_count):
            clip = clip_to_int16(clip)
            n = max(-(-len(clip) // hop), min_chunks)
            padded = np.zeros(n * hop, np.int16)
            padded[: len(clip)] = clip
            chunk_parts.append(padded.reshape(n, hop))
            offsets.append(chunk_pos)
            counts.append(n)
            chunk_pos += n
            n_clips += 1
        if n_clips == 0:
            continue
        p_logit.append(np.log(p.sampling_weight) if p.sampling_weight > 0 else -1e30)
        p_start.append(clip_pos)
        p_count.append(n_clips)
        p_label.append(p.label)
        p_penalty.append(p.penalty_weight)
        p_strategy.append(_STRATEGY_IDS[p.truncation_strategy])
        clip_pos += n_clips
    if not chunk_parts:
        raise ValueError("no audio clips found in any provider")
    total = chunk_pos - EDGE_PAD
    end_pad = EDGE_PAD + (-(EDGE_PAD + total)) % WIDE_K
    chunks = np.concatenate([np.zeros((EDGE_PAD, hop), np.int16)] + chunk_parts
                            + [np.zeros((end_pad, hop), np.int16)])

    def put(values, dtype):
        return torch.from_numpy(np.asarray(values, dtype)).to(dev)

    return PackedAudioData(
        chunks=torch.from_numpy(chunks).to(dev),
        clip_offset=put(offsets, np.int32),
        clip_chunks=put(counts, np.int32),
        provider_logits=put(p_logit, np.float32),
        provider_clip_start=put(p_start, np.int32),
        provider_clip_count=put(p_count, np.int32),
        provider_label=put(p_label, np.float32),
        provider_penalty=put(p_penalty, np.float32),
        provider_strategy=put(p_strategy, np.int32),
        hop_samples=hop,
        edge_pad=EDGE_PAD,
    )


def audio_windows_from_draws(data: PackedAudioData, prov: torch.Tensor, u_clip: torch.Tensor,
                             u_win: torch.Tensor, features_length: int):
    """The windows of one raw-audio draw: provider ids [B] and two [B]
    uniforms (clip, random start) -> (PCM [B, (L + wc - 1) * hop] int16,
    labels [B], weights [B]), placed as the JAX package's
    sample_audio_feature_batch places them (wc = window_chunks_for_hop).

    A window of L frames spans L + wc - 1 chunk rows: at 10 ms (L + 2) * 160
    samples give exactly L frames, at 20 ms (L + 1) * 320 do.  Clips longer
    than the window start per truncation strategy (fixed_right_cutoff and the
    eval-only strategies as random); shorter ones are right-aligned behind
    leading silence.  Rows outside the clip are zero.
    """
    off, n, start = audio_window_starts(data, prov, u_clip, u_win, features_length)
    n_chunks = features_length + window_chunks_for_hop(data.hop_samples) - 1
    windows, valid = gather_windows(data.chunks, off, n, start, n_chunks)
    pcm = torch.where(valid[:, :, None], windows, 0)  # int16
    return (pcm.reshape(len(prov), n_chunks * data.hop_samples), data.provider_label[prov],
            data.provider_penalty[prov])


def audio_window_starts(data: PackedAudioData, prov: torch.Tensor, u_clip: torch.Tensor,
                        u_win: torch.Tensor, features_length: int):
    """The chunk placement of ``audio_windows_from_draws``: (clip chunk offset
    [B], clip chunks [B], window start relative to the clip [B])."""
    n_chunks = features_length + window_chunks_for_hop(data.hop_samples) - 1
    count = data.provider_clip_count[prov]
    clip = data.provider_clip_start[prov] + torch.minimum(
        torch.floor(u_clip * count).to(torch.int32), count - 1)
    n = data.clip_chunks[clip]
    strategy = data.provider_strategy[prov]
    start_random = torch.floor(u_win * torch.clamp(n - n_chunks, min=1)).to(torch.int32)
    start_long = torch.where(strategy == TRUNCATE_START, n - n_chunks,
                             torch.where(strategy == TRUNCATE_END, torch.zeros_like(n), start_random))
    return data.clip_offset[clip], n, torch.where(n > n_chunks, start_long, n - n_chunks)


def audio_features(pcm: torch.Tensor, hop_samples: int, features_length: int) -> torch.Tensor:
    """Features [B, L, 40] of the gathered windows: the frontend kernel on the
    card (3 launches), its plain version on the CPU.  Each window's noise
    estimate starts from zero, as the JAX package's in-step frontend does.
    No windows (a rank's empty share of a mixed batch) launch nothing."""
    if pcm.shape[0] == 0:
        return torch.zeros((0, features_length, FC.NUM_CHANNELS), device=pcm.device)
    feats = frontend_batch(pcm, hop_samples // 16)
    if feats.shape[1] != features_length:
        raise ValueError(f"{pcm.shape[1]} samples gave {feats.shape[1]} frames, "
                         f"not {features_length}")
    return feats


def draw_audio_windows(data: PackedAudioData, generator: torch.Generator, batch_size: int,
                       features_length: int, rows: slice | None = None):
    """The raw-audio step's draw and gather: a Gumbel-max provider, clip and
    start uniforms from ``generator``, then ``audio_windows_from_draws``.
    Returns (PCM [B, (L + wc - 1) * hop] int16, labels [B], weights [B]), or
    the ``rows`` of them."""
    p = data.provider_logits.shape[0]
    u = torch.rand((batch_size, p + 2), generator=generator, device=data.device)
    if rows is not None:
        u = u[rows]
    prov = torch.argmax(data.provider_logits - torch.log(-torch.log(u[:, :p])), dim=1)
    return audio_windows_from_draws(data, prov, u[:, p], u[:, p + 1], features_length)


def sample_audio_feature_batch(data: PackedAudioData, generator: torch.Generator,
                               batch_size: int, features_length: int,
                               time_mask_max_size: int = 0, time_mask_count: int = 0,
                               freq_mask_max_size: int = 0, freq_mask_count: int = 0,
                               rows: slice | None = None):
    """One raw-audio training batch on the card: the draw and chunk gather
    (``draw_audio_windows``), the frontend (``audio_features``) and
    SpecAugment.  Returns (features [B, L, 40] float32 in [0, 26], labels
    [B], weights [B]), or the ``rows`` of them.

    The frontend runs on the sampled window only, so the noise estimate
    starts fresh at the window start (the reference's on-the-fly mode
    computes a whole clip before truncating, data.py:324-402; the difference
    is a few frames of gain ramp at the start, like a clip recorded from
    silence).
    """
    pcm, labels, weights = draw_audio_windows(data, generator, batch_size, features_length, rows)
    feats = audio_features(pcm, data.hop_samples, features_length)
    if time_mask_count or freq_mask_count:
        feats = apply_spec_augment(generator, feats, time_mask_max_size, time_mask_count,
                                   freq_mask_max_size, freq_mask_count, batch_size, rows)
    return feats, labels, weights


@dataclasses.dataclass(frozen=True)
class PackedMixedData:
    """Mixed-provider raw-audio corpus: clips-type providers as raw audio (the
    in-step frontend) and mmap providers as precomputed spectrograms, in one
    step (the reference FeatureHandler mixes provider types per sample,
    data.py:405-466).

    The batch splits into two sub-batches of static size in proportion to the
    two classes' total sampling weight (``audio_fraction``), and providers
    are drawn within each: each sample's provider has the reference's
    distribution in expectation, the batch's composition the binomial mean.
    """

    audio: PackedAudioData
    spec: PackedTrainingData
    audio_fraction: float = 0.5

    @property
    def device(self) -> torch.device:
        return self.audio.device


def pack_mixed_data(providers, device=None, shard_index: int = 0, shard_count: int = 1,
                    step_ms: int = 10):
    """Packs a provider list for raw-audio training on ``device``: all
    clips-type -> PackedAudioData; clips-type and mmap -> PackedMixedData;
    all mmap -> PackedTrainingData.  mmap providers with no training clips
    (validation- or testing-only feature dirs) join no training corpus."""
    audio_p = [p for p in providers if hasattr(p, "generate_audio_pool")]
    spec_p = [p for p in providers if not hasattr(p, "generate_audio_pool")
              and any(len(s) for s in (p.stores or {}).get("training", []))]
    if not spec_p:
        return pack_audio_data(audio_p, device, shard_index, shard_count, step_ms)
    if not audio_p:
        return pack_training_data(providers, device, shard_index, shard_count)
    w_audio = sum(p.sampling_weight for p in audio_p)
    w_spec = sum(p.sampling_weight for p in spec_p)
    return PackedMixedData(
        audio=pack_audio_data(audio_p, device, shard_index, shard_count, step_ms),
        spec=pack_training_data(spec_p, device, shard_index, shard_count),
        audio_fraction=float(w_audio / max(w_audio + w_spec, 1e-12)),
    )


def mixed_batch_sizes(batch_size: int, audio_fraction: float) -> tuple[int, int]:
    """(raw-audio rows, spectrogram rows): round(B * fraction) clamped to
    [1, B - 1]."""
    b_audio = max(1, min(batch_size - 1, int(round(batch_size * audio_fraction))))
    return b_audio, batch_size - b_audio


def sample_mixed_batch(data: PackedMixedData, generator: torch.Generator, batch_size: int,
                       features_length: int, time_mask_max_size: int = 0,
                       time_mask_count: int = 0, freq_mask_max_size: int = 0,
                       freq_mask_count: int = 0, rows: slice | None = None):
    """One mixed batch on the card: the raw-audio sub-batch (windows -> the
    frontend kernel) followed by the spectrogram sub-batch; or the ``rows``
    of it, each sub-batch drawn whole and cut to its part of the slice."""
    b_audio, b_spec = mixed_batch_sizes(batch_size, data.audio_fraction)
    masks = dict(time_mask_max_size=time_mask_max_size, time_mask_count=time_mask_count,
                 freq_mask_max_size=freq_mask_max_size, freq_mask_count=freq_mask_count)
    rows_audio = rows_spec = None
    if rows is not None:
        lo, hi, _ = rows.indices(batch_size)
        rows_audio = slice(min(lo, b_audio), min(hi, b_audio))
        rows_spec = slice(max(lo, b_audio) - b_audio, max(hi, b_audio) - b_audio)
    fa, la, wa = sample_audio_feature_batch(data.audio, generator, b_audio, features_length,
                                            rows=rows_audio, **masks)
    fs, ls, ws = sample_batch(data.spec, generator, b_spec, features_length, rows=rows_spec,
                              **masks)
    return torch.cat([fa, fs]), torch.cat([la, ls]), torch.cat([wa, ws])


def sample_any(packed, generator: torch.Generator, batch_size: int, features_length: int,
               rows: slice | None = None, **masks):
    """One training batch from any packed corpus, by its kind (the JAX
    package's make_train_step dispatch, train/loop.py:164-203); ``rows``
    cuts it to a slice of the batch (see the module's docstring)."""
    if isinstance(packed, PackedAudioData):
        return sample_audio_feature_batch(packed, generator, batch_size, features_length,
                                          rows=rows, **masks)
    if isinstance(packed, PackedMixedData):
        return sample_mixed_batch(packed, generator, batch_size, features_length, rows=rows,
                                  **masks)
    return sample_batch(packed, generator, batch_size, features_length, rows=rows, **masks)
