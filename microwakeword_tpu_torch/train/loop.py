"""Training loop (port of train/loop.py): on-device sampling, the train-mode
forward and backward, weighted BCE and Adam on one flat parameter vector,
periodic validation with two-step best-checkpoint selection, and
checkpoints.  The corpus on the card is spectrograms, raw augmented audio
(config ``raw_audio_training``: the frontend kernel runs inside the step) or
both, and ``pool_refresh_steps`` refreshes the audio pools from a host thread
(``data/refresh.py``; over a mesh rank 0 builds each pool and broadcasts
it).  A spectrogram corpus over the card's budget, or any with config
``corpus_residency: host``, stays in host RAM and each step's batch is drawn
and gathered on the host and copied to the card (``data/host_stream.py``).
Over a data-parallel mesh (``mesh``: one rank per process, ``parallel/``)
each rank computes its block of the global batch, the corpus is replicated
or sharded (config ``corpus_sharding``), validation rows are split over the
ranks, and only rank 0 writes files.

Schedules are padded with their last entry, Adam runs on probabilities'
weighted BCE, validation runs every ``eval_step_interval`` steps and writes
the best/last/restore artifacts, as in the reference train.py and the JAX
package.  The step runs eagerly: the sampler, the model and Adam are stock
PyTorch ops on the card, and nothing in a step waits for the host.

Checkpoints keep the JAX package's file stems in the port's own format,
``torch.save`` of plain tensors (``best_weights.pt``, ``last_weights.pt``,
``restore/ckpt.pt``, ``train/<int(best_min * 10000)>_weights_<step>.pt``).
The JAX package's migration of per-leaf Adam checkpoints has no port-side
checkpoints to migrate and is left out.  When ``tensorboardX`` imports, rank
0 also writes the JAX package's TensorBoard scalars under ``logs/train`` and
``logs/validation``; metrics.jsonl holds every eval's record either way.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.data.host_stream import (
    HostBatchProducer,
    HostStreamedData,
    pack_training_with_residency,
)
from microwakeword_tpu_torch.data.refresh import PoolRefresher
from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.models.layers import BatchNorm
from microwakeword_tpu_torch.trace import span
from microwakeword_tpu_torch.train import metrics as M

EPS = 1e-7  # Keras BinaryCrossentropy epsilon
# optax.adam as the JAX package configures it: Keras' epsilon, outside the
# square root; eps_root 0.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7


def adam(flat, grad, mu, nu, count, neg_lr) -> None:
    """optax's ``scale_by_adam`` and the step, in its arithmetic and order,
    on a flat vector in place: moments ``(1 - b) * g + b * m``, bias
    correction by ``1 - b ** count``, ``m_hat / (sqrt(v_hat) + eps)``, times
    ``neg_lr`` (-lr: a float for one model, [N, 1] for a population)."""
    mu.mul_(ADAM_B1).add_(grad, alpha=1.0 - ADAM_B1)
    nu.mul_(ADAM_B2).addcmul_(grad, grad, value=1.0 - ADAM_B2)
    count.add_(1)
    c = count.to(flat.dtype)
    # true division by 0-dim device tensors, as JAX divides (a Python
    # scalar divisor becomes a reciprocal multiply on the card)
    mu_hat = mu / (1.0 - torch.pow(ADAM_B1, c))
    denom = torch.sqrt(nu / (1.0 - torch.pow(ADAM_B2, c))).add_(ADAM_EPS)
    flat.add_(mu_hat.div_(denom).mul_(neg_lr))


def flat_layout(tensors, lead: tuple = ()):
    """``tensors`` (each [*lead, *shape]: ``lead`` is () for one model, (N,)
    for a population) copied into one flat vector [*lead, P]; returns (flat,
    a view of it in each tensor's shape, and Adam's zero state beside it:
    grad, mu, nu like flat and an int32 count)."""
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(*lead, -1) for t in tensors], dim=len(lead))
    views, offset = [], 0
    for t in tensors:
        size = math.prod(t.shape[len(lead):])
        views.append(flat[..., offset : offset + size].view(t.shape))
        offset += size
    count = torch.zeros((), dtype=torch.int32, device=flat.device)
    return flat, views, torch.zeros_like(flat), torch.zeros_like(flat), torch.zeros_like(flat), count


def loss_weights(penalties, labels, positive_class_weight, negative_class_weight):
    """Each row's loss weight: its penalty times its class's weight."""
    return penalties * torch.where(labels > 0.5, positive_class_weight, negative_class_weight)


def pad_schedule(values, n):
    """Pad a per-phase list with its last entry (reference train.py:190-204)."""
    values = list(values)
    while len(values) < n:
        values.append(values[-1])
    return values


def resolve_schedules(config: dict) -> list[dict]:
    """One dict of hyperparameters per training phase."""
    steps = list(config.get("training_steps") or [20000])
    n = len(steps)
    keys = {
        "learning_rates": [0.001],
        "mix_up_augmentation_prob": [0.0],
        "freq_mix_augmentation_prob": [0.0],
        "time_mask_max_size": [5],
        "time_mask_count": [2],
        "freq_mask_max_size": [5],
        "freq_mask_count": [2],
        "positive_class_weight": [1.0],
        "negative_class_weight": [1.0],
    }
    resolved = {k: pad_schedule(config.get(k) or dflt, n) for k, dflt in keys.items()}
    return [
        {
            "steps": steps[i],
            "learning_rate": float(resolved["learning_rates"][i]),
            "time_mask_max_size": int(resolved["time_mask_max_size"][i]),
            "time_mask_count": int(resolved["time_mask_count"][i]),
            "freq_mask_max_size": int(resolved["freq_mask_max_size"][i]),
            "freq_mask_count": int(resolved["freq_mask_count"][i]),
            "positive_class_weight": float(resolved["positive_class_weight"][i]),
            "negative_class_weight": float(resolved["negative_class_weight"][i]),
        }
        for i in range(n)
    ]


def weighted_bce(probs: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Keras-style weighted BCE on probabilities: the batch mean of
    weight * bce (reduction sum_over_batch_size)."""
    p = torch.clamp(probs.reshape(-1), EPS, 1.0 - EPS)
    y = labels.reshape(-1)
    bce = -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))
    return torch.mean(weights.reshape(-1) * bce)


class TrainStep:
    """The train step over a device-resident corpus (``make_train_step``).

    The module's parameters become views into one flat vector (fp32 in
    training; a float64 module gives a float64 step, as the card-against-CPU
    check uses it), and their gradients are gathered into one flat vector,
    so Adam (``adam``) is a handful of vector ops.  The BatchNorm statistics
    update in the module's buffers.

    ``step(**phase)`` draws the batch from the corpus with ``generator``
    (``sampler.sample_any``: spectrograms, raw audio through the frontend
    kernel, or both), and the model's keep mask, where it has one
    (Inception's ``keep_mask``), from the same generator; ``step_on_batch``
    takes a gathered batch of spectrogram windows instead (the host-streamed
    form, ``data/host_stream.py``), with a leading [steps] axis for several
    sub-steps.
    Either reports the last sub-step's metrics (0-dim tensors).  Under a
    torch profiler each sub-step is a ``train.step`` span holding
    ``train.sample``, ``train.forward``, ``train.backward`` and
    ``train.adam``, and the report a ``train.report`` after them
    (``trace.py``).

    With a ``mesh`` (``parallel/mesh.py``) this is one rank's step of the
    data-parallel step on the global batch of ``batch_size`` rows
    (``parallel/train_step.py`` says how it stays the solo step); without
    one, ``rows`` is None, the share is 1 and no collective runs.
    """

    def __init__(self, bundle, model: torch.nn.Module, packed,
                 batch_size: int, features_length: int, steps_per_call: int = 1,
                 generator: torch.Generator | None = None, mesh=None, sharded: bool = False):
        self.bundle = bundle
        self.model = model
        self.packed = packed
        self.batch_size = int(batch_size)
        self.features_length = int(features_length)
        self.steps_per_call = int(steps_per_call)
        self.generator = generator
        self.params = list(model.parameters())
        self.device = self.params[0].device
        self.flat, views, self.grad, self.mu, self.nu, self.count = flat_layout(self.params)
        for p, view in zip(self.params, views):
            p.data = view
        self.mesh = mesh
        self.sharded = bool(sharded)
        # this rank's block of the global batch (None: all of it) and its
        # share of the batch: 1.0 on one rank, a power of two (exact) on 2,
        # 4, 8
        self.rows = None if mesh is None else mesh.rows(self.batch_size)
        self.local_batch = self.batch_size // (1 if mesh is None else mesh.size)
        self.share = self.local_batch / self.batch_size
        self.batch_norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
        if mesh is not None:
            with torch.no_grad():
                mesh.broadcast(self.flat)
                for buf in model.buffers():
                    mesh.broadcast(buf)
            for bn in self.batch_norms:
                bn.stats_reduce = self._reduce_stats

    # ---- optimizer state ----------------------------------------------
    def opt_state(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_opt_state(self, state: dict) -> None:
        with torch.no_grad():
            for key, value in self.opt_state().items():
                value.copy_(state[key])

    # ---- one sub-step ---------------------------------------------------
    def _adam(self, learning_rate: float) -> None:
        adam(self.flat, self.grad, self.mu, self.nu, self.count, -learning_rate)

    def _reduce_stats(self, mean: torch.Tensor, mean_sq: torch.Tensor):
        """BatchNorm's hook over a mesh: this rank's E[x] and E[x^2] times its
        share, summed over the ranks (one all-reduce in each pass)."""
        both = self.mesh.all_reduce_autograd(torch.cat([mean, mean_sq]) * self.share)
        return both[: mean.shape[0]], both[mean.shape[0] :]

    def _keep_mask(self) -> torch.Tensor | None:
        """Over a mesh, this rank's rows of the model's keep mask, drawn after
        the batch as the solo step's forward draws it; None where the forward
        draws its own (no mesh) or the model draws none."""
        if self.mesh is None:
            return None
        if self.sharded:
            return self.model.keep_mask(self.local_batch, self.generator)
        keep = self.model.keep_mask(self.batch_size, self.generator)
        return None if keep is None else keep[self.rows]

    def _sub_step(self, feats, labels, penalties, learning_rate: float,
                  positive_class_weight: float, negative_class_weight: float):
        with span("train.forward"):
            weights = loss_weights(penalties, labels, positive_class_weight, negative_class_weight)
            keep = self._keep_mask()
            probs = self.bundle.forward_train(self.model, feats.to(self.flat.dtype),
                                              self.generator if keep is None else keep)
            loss = weighted_bce(probs, labels, weights)
            if self.mesh is not None:
                loss = loss * self.share  # the ranks' losses sum to the global batch mean
        with span("train.backward"):
            grads = torch.autograd.grad(loss, self.params)
            torch.cat([g.reshape(-1) for g in grads], out=self.grad)
            if self.mesh is not None:
                self.mesh.all_reduce(self.grad)
        with torch.no_grad(), span("train.adam"):
            self._adam(learning_rate)
        return probs.detach(), labels, loss.detach()

    @staticmethod
    def _split_phase(phase: dict):
        masks = {k: phase[k] for k in ("time_mask_max_size", "time_mask_count",
                                       "freq_mask_max_size", "freq_mask_count")}
        opt = {k: phase[k] for k in ("learning_rate", "positive_class_weight",
                                     "negative_class_weight")}
        return masks, opt

    def _report(self, last) -> dict:
        """binary_metrics and the loss of the batch; over a mesh, of the
        global batch: one gather of each rank's [probs | labels] rows and
        loss, in rank order."""
        probs, labels, loss = last
        if self.mesh is not None:
            local = torch.cat([torch.stack([probs.reshape(-1), labels.reshape(-1).to(probs.dtype)],
                                           dim=1).reshape(-1), loss.reshape(1)])
            glob = self.mesh.gather_rows(local[None])
            rows = glob[:, :-1].reshape(-1, 2)
            probs, labels, loss = rows[:, :1], rows[:, 1], glob[:, -1].sum()
        metrics = M.binary_metrics(probs, labels)
        metrics["loss"] = loss
        return metrics

    def step(self, steps: int | None = None, **phase) -> dict:
        """``steps`` (default steps_per_call) sub-steps on batches sampled
        on the card; the last sub-step's metrics.  Over a mesh a replicated
        corpus draws the global batch and computes this rank's rows; a
        sharded one draws this rank's rows alone."""
        masks, opt = self._split_phase(phase)
        n, rows = (self.local_batch, None) if self.sharded else (self.batch_size, self.rows)
        for _ in range(self.steps_per_call if steps is None else steps):
            with span("train.step"):
                with span("train.sample"):
                    feats, labels, penalties = S.sample_any(
                        self.packed, self.generator, n, self.features_length, rows=rows, **masks)
                last = self._sub_step(feats, labels, penalties, **opt)
        with span("train.report"):
            return self._report(last)

    def step_on_batch(self, windows, valid, labels, weights, **phase) -> dict:
        """The step on a gathered batch: windows [B, L, F] int16 (uint16
        bits), valid [B, L], labels [B], penalty weights [B]; or each with a
        leading [steps] axis, one sub-step per entry.  Over a mesh this rank
        computes its rows of the global batch, SpecAugment drawn for all."""
        masks, opt = self._split_phase(phase)
        batches = [(windows, valid, labels, weights)]
        if windows.dim() == 4:
            batches = list(zip(windows, valid, labels, weights))
        r = slice(None) if self.rows is None else self.rows
        for w, v, y, pen in batches:
            with span("train.step"):
                with span("train.sample"):
                    feats = S.finish_batch(self.generator, w[r], v[r], **masks,
                                           batch_size=w.shape[0], rows=self.rows)
                last = self._sub_step(feats, y[r], pen[r], **opt)
        with span("train.report"):
            return self._report(last)


def make_train_step(bundle, model, packed, batch_size: int, features_length: int,
                    steps_per_call: int = 1, generator: torch.Generator | None = None) -> TrainStep:
    """The train step over ``packed`` (PackedTrainingData, PackedAudioData or
    PackedMixedData on the model's device); see TrainStep."""
    return TrainStep(bundle, model, packed, batch_size, features_length, steps_per_call, generator)


def make_eval_fn(bundle, eval_batch: int = 1024, mesh=None):
    """Chunked eval-mode forward: (model, x [N, T, F] tensor or array) ->
    numpy probabilities [N].  Over a ``mesh`` each chunk (eval_batch rounded
    up to a multiple of its size) is zero padded to a multiple of the size,
    each rank runs its block of rows, and the blocks are gathered in rank
    order: every rank returns all N."""
    if mesh is not None:
        eval_batch = -(-eval_batch // mesh.size) * mesh.size

    def chunk_probs(model, chunk):
        if mesh is None:
            return bundle.forward(model, chunk).reshape(-1)
        n = chunk.shape[0]
        pad = -n % mesh.size
        if pad:
            chunk = torch.cat([chunk, chunk.new_zeros((pad,) + chunk.shape[1:])])
        rows = mesh.rows(n + pad)
        return mesh.gather_rows(bundle.forward(model, chunk[rows]).reshape(-1))[:n]

    @torch.inference_mode()
    def eval_probs(model, x) -> np.ndarray:
        device = next(model.parameters()).device
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        outs = [chunk_probs(model, x[i : i + eval_batch])
                for i in range(0, x.shape[0], eval_batch)]
        return torch.cat(outs).cpu().numpy() if outs else np.zeros((0,), np.float32)

    return eval_probs


def _weights_state(model: torch.nn.Module) -> dict:
    """The module's parameters and BatchNorm statistics as plain CPU tensors
    (copies: the parameters are views into the flat vector)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def _save(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(obj, path)


def model_summary(model: torch.nn.Module) -> str:
    """Per-layer parameter table, the counterpart of the reference's Keras
    model.summary() (utils.py:131-145)."""
    lines = [f"{'layer':<60} {'shape':<20} {'params':>10}", "-" * 92]
    params = dict(model.named_parameters())
    total = 0
    for coll, entries in (
        ("params", params.items()),
        ("batch_stats", [(k, v) for k, v in model.state_dict().items() if k not in params]),
    ):
        for name, leaf in entries:
            n = leaf.numel()
            if coll == "params":
                total += n
            lines.append(f"{coll + ':' + name:<60} {str(tuple(leaf.shape)):<20} {n:>10,}")
    lines.append("-" * 92)
    lines.append(f"Total trainable params: {total:,}")
    return "\n".join(lines)


# config frontend_backend: the JAX package's two in-step frontends (XLA ops
# or its Pallas kernel); both name the port's one frontend, the CUDA kernel.
FRONTEND_BACKENDS = ("xla", "pallas")


def _check_frontend_backend(config: dict) -> None:
    backend = config.get("frontend_backend", "xla")
    if backend not in FRONTEND_BACKENDS:
        raise ValueError(f"frontend_backend must be one of {FRONTEND_BACKENDS}, got {backend!r}")


# the JAX train()'s notice, word for word
REFRESH_IGNORED = ("pool_refresh_steps ignored: background pool refresh applies to HBM-resident "
                   "clips pools, not host-streamed/mesh-sharded corpora")


def _pack(config: dict, feature_handler, dev: torch.device, mesh):
    """The training corpus: (packed, sharded).  Over a mesh, raw audio is
    replicated from rank 0 and spectrograms follow ``corpus_sharding``; one
    device keeps spectrograms on it or in host RAM by ``corpus_residency``."""
    step_ms = int(config.get("window_step_ms", 10))
    if mesh is None:
        if config.get("raw_audio_training"):
            # audio pools are bounded by pack_pool_size: no corpus budget check
            return feature_handler.pack_training_audio(dev, step_ms=step_ms), False
        return pack_training_with_residency(feature_handler.providers, config, dev), False
    from microwakeword_tpu_torch.parallel.corpus import broadcast_packed, pack_for_mesh

    if config.get("raw_audio_training"):
        packed = feature_handler.pack_training_audio(dev, step_ms=step_ms) if mesh.is_main else None
        return broadcast_packed(packed, mesh), False
    if str(config.get("corpus_residency", "auto")) == "host":
        raise ValueError(
            "corpus_residency: host is single-device; with a mesh the corpus is divided across "
            "devices instead -- set corpus_sharding: shard")
    return pack_for_mesh(feature_handler.providers, config, mesh)


# the train step's scalars that the TensorBoard summaries carry
TRAIN_SUMMARIES = ("loss", "accuracy", "recall", "precision", "auc")


def _summary_writers(train_dir: str) -> dict:
    """tensorboardX writers of ``logs/train`` and ``logs/validation`` under
    ``train_dir``, as the JAX train() opens them; none when tensorboardX
    does not import (it is optional, and guards no device)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return {}
    return {name: SummaryWriter(os.path.join(train_dir, "logs", name))
            for name in ("train", "validation")}


def train(bundle, config: dict, feature_handler, restore_checkpoint: bool = False,
          device=None, mesh=None):
    """Trains a model on ``device`` (default the card); returns (model,
    history).

    config keys follow the reference YAML schema: training_steps,
    learning_rates, *_mask_*, positive/negative_class_weight, batch_size,
    spectrogram_length, eval_step_interval, train_dir, minimization_metric,
    maximization_metric, target_minimization, seed, steps_per_call,
    profile_dir, raw_audio_training, window_step_ms, frontend_backend,
    pool_refresh_steps, pool_refresh_blocking, corpus_residency,
    corpus_sharding.  ``mesh`` is a ``parallel.mesh.Mesh`` or a rank count
    (None or 1: one device): the run is data parallel over its ranks, on
    the mesh's device, and every rank returns the same model.
    """
    from microwakeword_tpu_torch.parallel.mesh import resolve_mesh

    _check_frontend_backend(config)
    dev = resolve_device(device)
    mesh = resolve_mesh(mesh, dev)
    if mesh is not None:
        dev = mesh.device
    main = mesh is None or mesh.is_main
    train_dir = config["train_dir"]
    os.makedirs(train_dir, exist_ok=True)
    batch_size = int(config.get("batch_size", 128))
    features_length = int(config["spectrogram_length"])
    seed = int(config.get("seed", 0))

    model = bundle.init(torch.Generator().manual_seed(seed), device=dev)
    if main:
        with open(os.path.join(train_dir, "model_summary.txt"), "w") as f:
            f.write(model_summary(model) + "\n")

    packed, sharded = _pack(config, feature_handler, dev, mesh)
    spc_cfg = config.get("steps_per_call", "auto")
    # auto: one step per call on the card for now (a CUDA graph of the step
    # is queued in ROADMAP section 2, item 4a)
    steps_per_call = 1 if spc_cfg in ("auto", None, "") else int(spc_cfg)
    producer = None
    if isinstance(packed, HostStreamedData):
        # the host's draws come from a CPU generator seeded like the card's
        producer = HostBatchProducer(packed, batch_size, features_length, steps_per_call, dev,
                                     torch.Generator().manual_seed(seed))
        packed = None
    if mesh is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
        train_step = make_train_step(bundle, model, packed, batch_size, features_length,
                                     steps_per_call, generator)
    else:
        from microwakeword_tpu_torch.parallel.train_step import (
            make_sharded_train_step,
            shard_seed,
        )

        generator = torch.Generator(device=dev).manual_seed(
            shard_seed(seed, mesh.rank) if sharded else seed)
        train_step = make_sharded_train_step(bundle, model, packed, batch_size, features_length,
                                             mesh, steps_per_call, generator, sharded)
    eval_probs = make_eval_fn(bundle, mesh=mesh)
    refresher = None
    refresh_steps = int(config.get("pool_refresh_steps", 0) or 0)
    if refresh_steps > 0 and (producer is not None or sharded):
        if main:
            print(REFRESH_IGNORED, flush=True)
        refresh_steps = 0
    if refresh_steps > 0:
        refresher = PoolRefresher(feature_handler, packed, refresh_steps, mesh=mesh).start()
    writers = _summary_writers(train_dir) if main else {}
    try:
        out = _train_loop(config, feature_handler, restore_checkpoint, model, train_step,
                          eval_probs, refresher, producer, main, writers)
    finally:
        if refresher is not None:
            refresher.stop()
        for writer in writers.values():
            writer.close()
    if mesh is not None:
        mesh.barrier()  # rank 0's files are written before any rank reads them
    return out


def _train_loop(config: dict, feature_handler, restore_checkpoint: bool, model,
                train_step: TrainStep, eval_probs, refresher, producer=None, main: bool = True,
                writers: dict | None = None):
    """train()'s steps, evals and checkpoints; returns (model, history).  With
    a ``producer`` (host mode) each step's batch comes from it; only ``main``
    (rank 0 of a mesh) writes files, and the TensorBoard scalars to
    ``writers`` (``_summary_writers``) at the JAX package's steps."""
    writers = writers or {}
    train_dir = config["train_dir"]
    phases = resolve_schedules(config)
    total_steps = sum(p["steps"] for p in phases)
    batch_size, features_length = train_step.batch_size, train_step.features_length
    eval_interval = int(config.get("eval_step_interval", 500))
    steps_per_call = train_step.steps_per_call
    dev = train_step.device
    restored_from_step = 0
    ckpt_path = os.path.join(train_dir, "restore", "ckpt.pt")
    if restore_checkpoint and os.path.exists(ckpt_path):
        restored = torch.load(ckpt_path, map_location=dev, weights_only=True)
        with torch.no_grad():
            model.load_state_dict(restored["weights"])
        train_step.load_opt_state(restored["opt_state"])
        # reference-compatible resume (train.py:229-233): weights and
        # optimizer restore, the configured schedule restarts
        restored_from_step = int(restored["step"])

    # --- validation data, assembled once ------------------------------
    data_rng = np.random.default_rng(int(config.get("seed", 0)))
    has_val = feature_handler.get_mode_size("validation") > 0
    val_x = val_y = None
    if has_val:
        val_x, val_y, _ = feature_handler.get_data(
            "validation", batch_size=batch_size, features_length=features_length,
            truncation_strategy="truncate_start", rng=data_rng)
        val_x = torch.as_tensor(val_x, device=dev)
    ambient_x = None
    ambient_hours = 0.0
    if feature_handler.get_mode_size("validation_ambient") > 0:
        ambient_x, _, _ = feature_handler.get_data(
            "validation_ambient", batch_size=batch_size, features_length=features_length,
            truncation_strategy="split", rng=data_rng)
        ambient_x = torch.as_tensor(ambient_x, device=dev)
        ambient_hours = feature_handler.get_mode_duration("validation_ambient") / 3600.0

    history_path = os.path.join(train_dir, "metrics.jsonl")
    history = []
    best_min = 10000.0
    best_max = 0.0
    best_no_faph_cutoff = 1.0
    saturated_evals = 0  # consecutive evals with degenerate selection metrics
    minimization_metric = config.get("minimization_metric")
    maximization_metric = config.get("maximization_metric", "average_viable_recall")
    target_min = float(config.get("target_minimization", 0.9))

    # optional torch.profiler capture of the hot loop once warm (rank 0's)
    profile_dir = config.get("profile_dir") if main else None
    profile_after = int(config.get("profile_after", 2))
    profile_steps = int(config.get("profile_steps", 20))
    profiler = None

    # steps_per_sec: the steps of each eval interval over the host's time from
    # the previous eval's record to this eval's float() of the step metrics,
    # which waits for the card: steps done, not steps enqueued
    interval_start, interval_steps = time.perf_counter(), 0
    step = 0
    while step < total_steps:
        if profile_dir and profiler is None and step >= profile_after:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
            profile_end = step + profile_steps
        # phase lookup (reference train.py:249-263); step + 1 is the step
        # about to run
        s, phase, phase_end = 0, phases[-1], total_steps
        for p in phases:
            s += p["steps"]
            if step + 1 <= s:
                phase, phase_end = p, s
                break
        # chain steps only within one phase and up to the next eval
        next_eval = step + eval_interval - (step % eval_interval)
        room = min(phase_end, next_eval, total_steps) - step
        n = steps_per_call if room >= steps_per_call else 1
        hyper = {k: v for k, v in phase.items() if k != "steps"}
        if producer is None:
            step_metrics = train_step.step(steps=n, **hyper)
        else:
            step_metrics = train_step.step_on_batch(*producer(n), **hyper)
        step += n
        interval_steps += n
        if refresher is not None:
            refresher.maybe_swap(train_step.packed, step,
                                 block=bool(config.get("pool_refresh_blocking", False)))
        if profiler is not None and profile_dir and step >= profile_end:
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            profile_dir = None

        if step % eval_interval == 0 or step == total_steps:
            sm = {k: float(v) for k, v in step_metrics.items()}
            steps_per_sec = interval_steps / max(time.perf_counter() - interval_start, 1e-9)
            if "train" in writers:
                for k in TRAIN_SUMMARIES:
                    writers["train"].add_scalar(k, sm[k], step)
            if main:
                _save(os.path.join(train_dir, "last_weights.pt"), _weights_state(model))

            val_metrics = {}
            if has_val:
                vp = eval_probs(model, val_x)
                ap = eval_probs(model, ambient_x) if ambient_x is not None and len(ambient_x) else None
                val_metrics = M.validation_metrics(vp, val_y, ap, ambient_hours)
                if "validation" in writers:
                    for k, v in val_metrics.items():
                        writers["validation"].add_scalar(k, v, step)
                current_min = float(val_metrics[minimization_metric]) if minimization_metric else 0.0
                current_max = float(val_metrics[maximization_metric])
                # per-eval breadcrumb (reference train.py:391-399)
                if main:
                    _save(os.path.join(train_dir, "train",
                                       f"{int(best_min * 10000)}_weights_{step}.pt"),
                          _weights_state(model))
                # Once faph == 0 and average_viable_recall == 1.0, every
                # later eval ties and selection freezes at the first such
                # eval (reference semantics, train.py:411-442).
                if (minimization_metric and current_min == 0.0
                        and float(val_metrics.get("average_viable_recall", 0.0)) >= 1.0):
                    saturated_evals += 1
                    if saturated_evals == 3:
                        print(
                            "WARNING: validation metrics saturated "
                            f"({minimization_metric}=0 and average_viable_recall=1.0 for 3 "
                            "consecutive evals) -- best-checkpoint selection is frozen at the "
                            "first saturated eval. Use longer/harder validation_ambient audio "
                            "so selection stays informative.",
                            flush=True,
                        )
                else:
                    saturated_evals = 0
                if M.is_new_best(current_min, current_max, best_min, best_max, target_min):
                    best_min, best_max = current_min, current_max
                    best_no_faph_cutoff = val_metrics["cutoff_for_no_faph"]
                    if main:
                        state = _weights_state(model)
                        _save(os.path.join(train_dir, "best_weights.pt"), state)
                        _save(ckpt_path, {"weights": state,
                                          "opt_state": _opt_state_cpu(train_step), "step": step})

            record = {
                "step": step + restored_from_step,
                "train": sm,
                "validation": val_metrics,
                "best_minimization_quantity": best_min,
                "best_maximization_quantity": best_max,
                "best_no_faph_cutoff": best_no_faph_cutoff,
                "steps_per_sec": steps_per_sec,
            }
            if refresher is not None:
                record["pool_swaps"] = refresher.swap_count
            history.append(record)
            if main:
                with open(history_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            interval_start, interval_steps = time.perf_counter(), 0

    if profiler is not None and profile_dir:  # trace still open: short runs
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    if main:
        state = _weights_state(model)
        _save(ckpt_path, {"weights": state, "opt_state": _opt_state_cpu(train_step),
                          "step": total_steps})
        _save(os.path.join(train_dir, "last_weights.pt"), state)
        if not os.path.exists(os.path.join(train_dir, "best_weights.pt")):
            _save(os.path.join(train_dir, "best_weights.pt"), state)
    return model, history


def _opt_state_cpu(train_step: TrainStep) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in train_step.opt_state().items()}


def load_weights(bundle, path: str, device=None) -> torch.nn.Module:
    """A module holding the weights that train() saved at ``path``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return bundle.load(state, device)
