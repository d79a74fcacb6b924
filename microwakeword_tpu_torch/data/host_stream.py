"""Host-RAM-resident training corpus (port of data/host_stream.py): corpora
larger than the card's memory budget.

The spectrogram corpus normally lives on the card (``PackedTrainingData``),
which caps it at device memory.  In host mode:

- the corpus ``frames`` stay in host RAM as numpy (uint16 bits in int16, as
  ``sampler.frames_tensor`` holds them);
- each step's draws (provider, clip, window start) run on the host, from a
  CPU ``torch.Generator`` seeded from the config seed, over CPU copies of the
  metadata tables, through the same ``sampler.sample_batch_indices`` the
  card uses (``windows_from_draws``), so for the same draws the windows are
  bit-equal to the resident gather (tests/test_torch_host_stream.py);
- the host gathers the windows with one ``np.take`` into a pinned buffer and
  copies the batch (B * L * 40 int16, 2 MB at batch 128 x 204) to the card
  with ``non_blocking=True``.  Two pinned buffers alternate; an event
  recorded after each buffer's copy is waited on only before that buffer is
  filled again, two calls later, so the host never waits for the step that
  reads the batch.  SpecAugment and dropout stay on the step's generator on
  the card (``TrainStep.step_on_batch``).

Residency is decided at pack time against a budget
(``hbm_corpus_budget``: 60 % of the card's memory, the JAX package's share
of its device's ``bytes_limit``, or ``MWW_CORPUS_HBM_BUDGET`` bytes); config
``corpus_residency: auto|hbm|host``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.device import resolve_device

# Share of the card's memory budgeted for the training corpus; the rest is
# headroom for the weights, optimizer state, batches and the eval arrays.
_BUDGET_FRACTION = 0.6
# The budget of a CPU "device", which reports no memory size (the JAX
# package's default for platforms without memory stats).
_DEFAULT_BUDGET = 6 * 10**9


def hbm_corpus_budget(device=None) -> int:
    """The corpus byte budget on ``device`` (None: the card): the
    MWW_CORPUS_HBM_BUDGET env var (bytes), else 60 % of the card's total
    memory, else (the CPU) 6 GB."""
    env = os.environ.get("MWW_CORPUS_HBM_BUDGET")
    if env:
        return int(float(env))
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory * _BUDGET_FRACTION)
    return _DEFAULT_BUDGET


class HostStreamedData:
    """The training corpus with its frames in host RAM and its metadata as
    CPU tensors for the host's draws.  ``meta`` is a PackedTrainingData on
    the CPU whose ``frames`` is one zero row: the draws never read frames."""

    def __init__(self, arrays: dict):
        self.frames = np.ascontiguousarray(arrays["frames"], np.uint16).view(np.int16)
        meta = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in arrays.items() if k not in ("frames", "edge_pad")}
        self.meta = S.PackedTrainingData(
            frames=torch.zeros((1, self.frames.shape[1]), dtype=torch.int16),
            edge_pad=int(arrays.get("edge_pad", 0)), **meta)

    @property
    def nbytes(self) -> int:
        return int(self.frames.nbytes)


class HostBatchProducer:
    """Training batches for the card from a HostStreamedData.

    ``producer(n)`` draws n sub-batches on the host from ``generator`` (a CPU
    generator), gathers their windows into a pinned buffer and copies
    (windows [B, L, F] int16, valid [B, L] bool, labels [B], penalty weights
    [B]) to ``device`` without blocking; each gains a leading [n] axis when
    the producer was built for ``steps`` > 1, as ``TrainStep.step_on_batch``
    takes them.  ``waits`` counts the calls that found their buffer's
    previous copy still running and waited for it.
    """

    SLOTS = 2

    def __init__(self, data: HostStreamedData, batch_size: int, features_length: int,
                 steps: int = 1, device=None, generator: torch.Generator | None = None):
        self.data = data
        self.batch_size = int(batch_size)
        self.features_length = int(features_length)
        self.steps = int(steps)
        self.device = resolve_device(device)
        self.generator = generator if generator is not None else torch.Generator()
        pin = self.device.type == "cuda"
        rows = self.steps * self.batch_size
        width = data.frames.shape[1]

        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        self._slots = [dict(windows=buf((rows * self.features_length, width), torch.int16),
                            valid=buf((rows * self.features_length,), torch.bool),
                            labels=buf((rows,), torch.float32),
                            weights=buf((rows,), torch.float32), event=None)
                       for _ in range(self.SLOTS)]
        self._next = 0
        self.waits = 0

    def draw(self, n: int):
        """n sub-batches' draws on the host: (rows [n, B, L], valid [n, B, L],
        labels [n, B], weights [n, B]), CPU tensors."""
        parts = [S.sample_batch_indices(self.data.meta, self.generator, self.batch_size,
                                        self.features_length) for _ in range(n)]
        return tuple(torch.stack(t) for t in zip(*parts))

    def __call__(self, n: int | None = None):
        n = self.steps if n is None else int(n)
        if not 1 <= n <= self.steps:
            raise ValueError(f"{n} sub-batches from a producer built for {self.steps}")
        rows, valid, labels, weights = self.draw(n)
        slot = self._slots[self._next]
        self._next = (self._next + 1) % self.SLOTS
        if slot["event"] is not None and not slot["event"].query():
            self.waits += 1
            slot["event"].synchronize()  # this buffer's previous copy is still running
        k, b = rows.numel(), n * self.batch_size
        win = slot["windows"][:k]
        np.take(self.data.frames, rows.reshape(-1).numpy(), axis=0, out=win.numpy())
        slot["valid"][:k].copy_(valid.reshape(-1))
        slot["labels"][:b].copy_(labels.reshape(-1))
        slot["weights"][:b].copy_(weights.reshape(-1))
        lead = (n,) if self.steps > 1 else ()
        b_shape = lead + (self.batch_size,)
        out = (win.to(self.device, non_blocking=True, copy=True).view(
                   b_shape + (self.features_length, win.shape[1])),
               slot["valid"][:k].to(self.device, non_blocking=True, copy=True).view(
                   b_shape + (self.features_length,)),
               slot["labels"][:b].to(self.device, non_blocking=True, copy=True).view(b_shape),
               slot["weights"][:b].to(self.device, non_blocking=True, copy=True).view(b_shape))
        if self.device.type == "cuda":
            slot["event"] = torch.cuda.Event()
            slot["event"].record()
        return out


def corpus_nbytes(arrays: dict) -> int:
    return int(sum(a.nbytes for a in arrays.values() if hasattr(a, "nbytes")))


def pack_training_with_residency(providers, config: dict, device=None,
                                 shard_index: int = 0, shard_count: int = 1):
    """Packs the spectrogram corpus for ``device`` (None: the card) within the
    budget: a PackedTrainingData on the device or a HostStreamedData.

    config ``corpus_residency``:
    - "hbm": on the device; raises ValueError when the corpus exceeds the budget;
    - "host": host-streamed;
    - "auto" (default): on the device when it fits, host-streamed with a
      printed notice when it does not.
    """
    residency = str(config.get("corpus_residency", "auto"))
    if residency not in ("auto", "hbm", "host"):
        raise ValueError(f"corpus_residency must be auto|hbm|host, got {residency!r}")
    dev = resolve_device(device)
    arrays = S.pack_training_arrays(providers, shard_index, shard_count, dev)
    if residency == "host":
        return HostStreamedData(arrays)
    nbytes = corpus_nbytes(arrays)
    budget = hbm_corpus_budget(dev)
    if nbytes <= budget:
        return S.upload_training_arrays(arrays, dev)
    if residency == "auto":
        print(
            f"training corpus ({nbytes / 1e6:.1f} MB) exceeds the device's corpus budget "
            f"({budget / 1e6:.1f} MB); streaming it from host RAM (corpus_residency: auto). "
            "Set MWW_CORPUS_HBM_BUDGET or corpus_residency: hbm to override.",
            flush=True,
        )
        return HostStreamedData(arrays)
    raise ValueError(
        f"training corpus is {nbytes / 1e6:.1f} MB but the device's corpus budget is "
        f"{budget / 1e6:.1f} MB (corpus_residency: hbm). Options: corpus_residency: host "
        "(stream batches from host RAM), corpus_residency: auto, or MWW_CORPUS_HBM_BUDGET to "
        "raise the budget."
    )
