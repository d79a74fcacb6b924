"""The training corpus of a data-parallel mesh (port of parallel/corpus.py).

``corpus_sharding`` (config) places it:

- "replicate": every rank holds the whole corpus.  Rank 0 packs it and
  broadcasts it (``broadcast_packed``), so every rank holds the same clips
  even where a clips-type provider augments from fresh entropy; with the
  ranks' generators seeded alike the step equals the solo step.  Raises when
  the corpus is over the device's budget.
- "shard": rank r holds clips ``i % D == r`` of every store
  (``pack_training_arrays(shard_index=r, shard_count=D)``), padded to the
  largest rank's lengths as the JAX package stacks its per-device shards; a
  provider with no clips on a rank is there a padding row whose logit is
  -1e30, never drawn.  Capacity grows with the mesh; each rank draws from its
  own generator, so the numbers differ from solo, as in JAX.
- "auto" (default): replicate when the corpus fits the budget, else shard
  with a printed notice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.data.host_stream import corpus_nbytes, hbm_corpus_budget

NEG_INF_LOGIT = -1e30

# pack_training_arrays key -> the value its padding rows hold (JAX's
# _PAD_VALUES)
_PAD_VALUES = {
    "frames": 0,
    "clip_offset": 0,
    "clip_length": 1,
    "provider_logits": NEG_INF_LOGIT,  # never sampled
    "provider_clip_start": 0,
    "provider_clip_count": 1,
    "provider_label": 0.0,
    "provider_penalty": 0.0,
    "provider_strategy": 0,
    "provider_cutoffs": 0,
    "provider_n_cutoffs": 1,
}


def shard_lengths(arrays: dict) -> np.ndarray:
    """The leading lengths of a shard's arrays in ``_PAD_VALUES`` order."""
    return np.asarray([arrays[key].shape[0] for key in _PAD_VALUES], np.int64)


def pad_shard(arrays: dict, lengths) -> dict:
    """A shard's arrays padded to the ranks' largest ``lengths`` (frames to a
    multiple of WIDE_K) with ``_PAD_VALUES``, as JAX's shard_training_data
    pads each device's shard."""
    out = dict(arrays)
    for key, n in zip(_PAD_VALUES, np.asarray(lengths).tolist()):
        part = arrays[key]
        if key == "frames":
            n = -(-n // S.WIDE_K) * S.WIDE_K
        if part.shape[0] < n:
            fill = np.full((n - part.shape[0],) + part.shape[1:], _PAD_VALUES[key], part.dtype)
            out[key] = np.concatenate([part, fill], axis=0)
    return out


def pack_shard(providers, mesh) -> S.PackedTrainingData:
    """This rank's shard of the training corpus on its device, padded to the
    ranks' common lengths (one all-reduce of the lengths)."""
    arrays = S.pack_training_arrays(providers, mesh.rank, mesh.size, mesh.device)
    lengths = torch.as_tensor(shard_lengths(arrays), device=mesh.device)
    mesh.all_reduce(lengths, op=torch.distributed.ReduceOp.MAX)
    return S.upload_training_arrays(pad_shard(arrays, lengths.cpu().numpy()), mesh.device)


def broadcast_packed(packed, mesh):
    """Rank 0's packed corpus (a sampler dataclass, PackedMixedData's parts
    included) on every rank's device; the other ranks pass None."""

    def spec(obj):
        if isinstance(obj, torch.Tensor):
            return ("tensor", tuple(obj.shape), obj.dtype)
        if dataclasses.is_dataclass(obj):
            return (type(obj), {f.name: spec(getattr(obj, f.name))
                                for f in dataclasses.fields(obj)})
        return ("value", obj)

    def build(s, obj):
        if s[0] == "tensor":
            t = obj if obj is not None else torch.empty(s[1], dtype=s[2], device=mesh.device)
            return mesh.broadcast(t)
        if s[0] == "value":
            return s[1]
        cls, fields = s
        return cls(**{k: build(v, None if obj is None else getattr(obj, k))
                      for k, v in fields.items()})

    skeleton = mesh.broadcast_object(spec(packed) if mesh.is_main else None)
    return build(skeleton, packed if mesh.is_main else None)


def pack_for_mesh(providers, config: dict, mesh):
    """The spectrogram corpus of this rank by config ``corpus_sharding``
    (module docstring); returns (PackedTrainingData, sharded)."""
    mode = str(config.get("corpus_sharding", "auto"))
    if mode not in ("auto", "replicate", "shard"):
        raise ValueError(f"corpus_sharding must be auto|replicate|shard, got {mode!r}")
    if mode == "shard":
        return pack_shard(providers, mesh), True
    arrays = S.pack_training_arrays(providers, device=mesh.device) if mesh.is_main else None
    nbytes = mesh.broadcast_object(corpus_nbytes(arrays) if mesh.is_main else None)
    budget = hbm_corpus_budget(mesh.device)
    if nbytes <= budget:
        packed = S.upload_training_arrays(arrays, mesh.device) if mesh.is_main else None
        return broadcast_packed(packed, mesh), False
    if mode == "auto":
        if mesh.is_main:
            print(f"training corpus ({nbytes / 1e6:.1f} MB) exceeds the per-device budget "
                  f"({budget / 1e6:.1f} MB); sharding it over the mesh ({mesh.size} ranks, "
                  "corpus_sharding: auto).", flush=True)
        return pack_shard(providers, mesh), True
    raise ValueError(
        f"training corpus is {nbytes / 1e6:.1f} MB replicated per device but the per-device "
        f"budget is {budget / 1e6:.1f} MB (corpus_sharding: replicate). Options: "
        "corpus_sharding: shard (1/D of the clips per device), corpus_sharding: auto, or "
        "MWW_CORPUS_HBM_BUDGET to raise the budget.")
