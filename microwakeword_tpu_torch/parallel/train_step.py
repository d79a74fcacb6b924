"""Data-parallel train step (port of parallel/train_step.py).

The JAX package's sharded step is the solo step on the global batch: XLA's
partitioner splits the batch over the mesh and inserts the collectives, so
the loss, the BatchNorm statistics and the update are the global batch's up
to reduction order.  As there, the sharded step is the production step:
``train/loop.py``'s ``TrainStep`` given a mesh, one implementation for one
device and for many.  One rank of it computes its contiguous block of B/D
rows and the collectives make the rest global:

- BatchNorm: each rank's ``E[x]`` and ``E[x^2]``, times its share of the
  rows (B/D of B), are summed over the ranks by one all-reduce in the
  forward pass and one in the backward pass (``Mesh.all_reduce_autograd``),
  and the variance is the fast one of the solo step, ``max(0, E[x^2] -
  E[x]^2)`` (``torch.nn.SyncBatchNorm`` would merge variances by Welford and
  keep an unbiased running variance);
- the loss: each rank's weighted BCE over its rows times its share, so the
  ranks' losses sum to the global batch mean; one all-reduce sums the flat
  gradient before Adam;
- step metrics: one all-gather collects the probabilities, labels and
  losses in rank order, and ``binary_metrics`` runs on the global batch.

A replicated corpus draws the solo batch: every rank draws the uniforms of
the whole batch from the same generator (provider, clip, window, SpecAugment,
Inception's dropout keep mask) and gathers, runs the frontend on and computes
only its own rows (``sampler.sample_any(rows=...)``), so the step equals the
solo step from the same seed.  A sharded corpus (``parallel/corpus.py``)
holds 1/D of the clips on each rank, and each rank draws its B/D rows from
its own generator (``shard_seed``), the counterpart of JAX's
``fold_in(rng, axis_index)``.

The parameters and BatchNorm statistics start as rank 0's (one broadcast
each), and the identical update keeps them equal on every rank.  In a world
of one rank every share is 1.0 and every collective returns its input, so
the step is the solo step bit for bit.
"""

from __future__ import annotations

import torch

from microwakeword_tpu_torch.train.loop import TrainStep


def shard_seed(seed: int, rank: int) -> int:
    """The generator seed of a rank's draws from a sharded corpus: ``seed``
    in the high 32 bits, the rank in the low 32 (and of a population
    member's draws, ``population.member_seed``)."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(rank) & 0xFFFFFFFF)


def make_sharded_train_step(bundle, model, packed, batch_size: int, features_length: int, mesh,
                            steps_per_call: int = 1, generator: torch.Generator | None = None,
                            sharded: bool = False) -> TrainStep:
    """The train step of this rank of ``mesh``: ``TrainStep`` with the mesh,
    one implementation for one device and for many.  ``batch_size`` is the
    global batch, divisible by the mesh's size; ``packed`` is the replicated
    corpus (every rank's generator seeded alike), or with ``sharded`` this
    rank's shard (its generator seeded by ``shard_seed``).  ``step`` and
    ``step_on_batch`` take the solo step's arguments; ``step_on_batch``
    takes the global gathered batch and keeps this rank's rows.  Metrics
    are the global batch's.  Collectives per sub-step: two per BatchNorm
    and one for the gradient; one more per call for the metrics."""
    return TrainStep(bundle, model, packed, batch_size, features_length, steps_per_call,
                     generator, mesh=mesh, sharded=sharded)
