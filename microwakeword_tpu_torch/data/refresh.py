"""Background refresh of the augmented audio pools of raw-audio training
(port of data/refresh.py).

The reference draws a fresh augmentation per training sample
(data.py:324-402); the on-device sampler instead holds a pool of augmented
clips on the card, which a long run would otherwise reuse for millions of
samples.  A host thread regenerates every clips-type provider's pool while
the card trains, and the train loop copies a finished pool into the corpus's
``chunks`` tensor every ``pool_refresh_steps`` steps (config; with
``pool_refresh_blocking`` it waits for the build at each due step).

The swap keeps the original layout: ``clip_offset``, ``clip_chunks`` and the
provider tables stay, and each regenerated clip is written into its old slot,
end-aligned (wake words sit at clip ends; leading zeros read as silence) and
front-truncated if the new augmentation ran longer.  With the usual fixed
``augmentation_duration_s`` every clip fits its slot exactly.

Over a data-parallel mesh (``parallel/mesh.py``) the pools are replicated and
must stay equal on every rank, but augmentation draws fresh entropy, so a
refresher on each rank would build another pool.  Rank 0 alone runs the
thread and builds the whole pool; every rank reaches the same due steps (the
step counter is shared), and at each one rank 0 broadcasts its decision, a
one-element flag, then, if it swaps, the new chunks into every rank's tensor
in place.  No collective runs between due steps.
"""

from __future__ import annotations

import queue
import threading
import traceback
import warnings

import numpy as np
import torch

from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.trace import span


def _audio_part(packed):
    if isinstance(packed, S.PackedMixedData):
        return packed.audio
    if isinstance(packed, S.PackedAudioData):
        return packed
    return None


class PoolRefresher:
    """Regenerates the clips-type audio pools of ``packed`` (PackedAudioData,
    or the audio half of PackedMixedData; spectrograms on disk need no
    refresh) on a host thread; over a ``mesh``, on rank 0's thread alone
    (module docstring)."""

    def __init__(self, feature_handler, packed, interval_steps: int, shard_index: int = 0,
                 shard_count: int = 1, mesh=None):
        audio = _audio_part(packed)
        if audio is None:
            raise ValueError("pool_refresh_steps requires raw-audio training "
                             "(PackedAudioData or PackedMixedData)")
        self.interval = int(interval_steps)
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.providers = [p for p in feature_handler.providers if hasattr(p, "generate_audio_pool")]
        # the pack layout on the host, reused by every build
        self.chunk_shape = tuple(audio.chunks.shape)
        self.hop_samples = int(audio.hop_samples)
        self.clip_offset = audio.clip_offset.cpu().numpy()
        self.clip_chunks = audio.clip_chunks.cpu().numpy()
        self.provider_clip_start = audio.provider_clip_start.cpu().numpy()
        self.provider_clip_count = audio.provider_clip_count.cpu().numpy()
        self._last_swap_step = 0
        self.swap_count = 0
        self.mesh = mesh
        self.builds = mesh is None or mesh.is_main  # the other ranks receive rank 0's pools
        # a dead worker is reported once, so training does not go on on the
        # stale pool without a word
        self.failure: str | None = None
        self._failure_warned = False
        self._queue: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)

    def start(self) -> "PoolRefresher":
        if self.builds:
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stops the worker and waits for it.  A build in progress runs to
        the end of its provider's pool, so that no thread goes on augmenting,
        and reading clip files, after training."""
        self._stop.set()
        try:  # unblock a worker waiting on the full queue
            self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join()

    def _build_chunks(self) -> np.ndarray | None:
        """One regenerated pool in the original slot layout, a new array;
        None when stopped between two providers."""
        hop = self.hop_samples
        chunks = np.zeros(self.chunk_shape, np.int16)
        for pi, p in enumerate(self.providers):
            if self._stop.is_set():
                return None
            clips = p.generate_audio_pool(self.shard_index, self.shard_count)
            start = int(self.provider_clip_start[pi])
            count = int(self.provider_clip_count[pi])
            if len(clips) != count:
                # cycling duplicates augmentations and changes each clip's
                # share of the draws; the usual cause is a pool whose size
                # depends on chance (VAD trimming dropping clips)
                warnings.warn(
                    f"PoolRefresher: provider {pi} regenerated {len(clips)} clips for {count} "
                    f"packed slots; clips will be {'cycled' if len(clips) < count else 'truncated'} "
                    "to fit the layout")
                clips = [clips[i % len(clips)] for i in range(count)]
            for j, clip in zip(range(start, start + count), clips):
                clip = S.clip_to_int16(clip)
                slot = int(self.clip_chunks[j]) * hop
                buf = np.zeros(slot, np.int16)
                t = min(len(clip), slot)
                buf[slot - t :] = clip[len(clip) - t :]
                off = int(self.clip_offset[j])
                chunks[off : off + slot // hop] = buf.reshape(-1, hop)
        return chunks

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                chunks = self._build_chunks()
            except Exception as e:  # the thread's boundary: report, then end
                traceback.print_exc()
                self.failure = f"{type(e).__name__}: {e}"
                return
            if chunks is None:
                return
            while not self._stop.is_set():
                try:
                    self._queue.put(chunks, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def _ready_pool(self, step: int, block: bool) -> np.ndarray | None:
        """The built pool for a due step, or None: none is ready yet, or the
        worker died (the first such step warns; training goes on on the last
        pool)."""
        if self.failure is not None and self._queue.empty():
            if not self._failure_warned:
                warnings.warn(
                    f"PoolRefresher worker died ({self.failure}); training continues on the "
                    f"stale augmentation pool -- fresh augmentation is lost from step {step} on")
                self._failure_warned = True
            return None
        try:
            return self._queue.get(timeout=600.0) if block else self._queue.get_nowait()
        except queue.Empty:
            return None

    def maybe_swap(self, packed, step: int, block: bool = False) -> bool:
        """Copies a regenerated pool into ``packed``'s audio chunks if a swap
        is due at ``step`` and a pool is ready; returns whether it did.

        Non-blocking by default: a build still running swaps at a later
        step.  ``block=True`` (config ``pool_refresh_blocking``) waits for the
        build at every due step, so every interval trains on a fresh pool and
        the step rate becomes bound by host augmentation.  After the worker
        died, the first due step warns (training goes on on the last pool).

        The copy runs on the current stream after the steps already queued,
        which read the old pool, and before the next, so no step sees half a
        pool.  Its source is pageable memory and ``non_blocking`` is off:
        PyTorch synchronizes the stream after such a copy, so ``copy_``
        returns only when the card holds the new pool, and the worker may
        then reuse nothing of it anyway (it builds every pool into a new
        array).  A pinned source with ``non_blocking=True`` would return at
        once; its buffer could then be rebuilt only after an event recorded
        behind the copy had completed.  The one sync per swap costs the
        steps queued at that moment, every ``interval`` steps.

        Over a mesh every rank calls this at every step.  At a due step rank
        0 decides, the other ranks learn its decision from a one-element
        broadcast (its ``item()`` waits for it), and a swap broadcasts rank
        0's new chunks into every rank's tensor in place (``Mesh.broadcast``
        moves their bytes: int16 crosses neither NCCL nor gloo), so every
        rank swaps at the same steps to the same pool.  Both broadcasts count
        among the mesh's collectives.  Under a torch profiler a swap's copy
        is a ``refresh.swap`` span (``trace.py``); the build on the worker
        thread has none.
        """
        if step - self._last_swap_step < self.interval:
            return False
        chunks = self._ready_pool(step, block) if self.builds else None
        if self.mesh is not None:
            flag = torch.tensor([chunks is not None], dtype=torch.uint8, device=self.mesh.device)
            if not self.mesh.broadcast(flag).item():
                return False
        elif chunks is None:
            return False
        self._last_swap_step = step
        self.swap_count += 1
        with span("refresh.swap"):
            target = _audio_part(packed).chunks
            if chunks is not None:
                target.copy_(torch.from_numpy(chunks))
            if self.mesh is not None:
                self.mesh.broadcast(target)
        return True
