"""Population training (port of parallel/population.py): N models of one
architecture trained at once on one card.

Wake-word development sweeps seeds, learning rates and class weights over
models of 10^4 to 10^5 parameters, and one such model's train step leaves the
card idle most of the time: the host's launches bound it.  A population
stacks its members' weights on a leading [N] axis -- every parameter a view
[N, *shape] into one flat [N, P] vector, every BatchNorm statistic an
[N, *shape] tensor -- and runs the forward, backward and BatchNorm updates
under ``torch.func.vmap`` over ``torch.func.functional_call``: vmap's
batching rules fold the member axis into the batch or channel axes of each
operator (a conv of N members is one grouped conv), so each launch serves
every member.  Per-member Adam runs on the [N, P] vectors with a learning
rate per member, through the solo step's ``train.loop.adam``.

Batches: with ``share_batch=True`` one batch per step, drawn from member 0's
generator, serves every member (one gather for the population; member 0
follows its solo run).  With ``share_batch=False`` each member draws its own
batch from its own generator; the draws are per member (a few small launches
each), the window placement, gather, scaling and SpecAugment run once over
all N * B rows, and every member follows its own solo trajectory.  The
model's keep masks (Inception's ``keep_mask``) are drawn from each member's
generator in either mode, after its batch and SpecAugment draws (a solo
``TrainStep``'s order), and passed to the model.  The JAX package's private
path asks for its wide-row gather, a TPU layout with the same features; the
port has one gather.

Generators: member i draws from a device generator seeded by
``member_seed(sample_seed, seeds[i])``, and its weights come from
``bundle.init(torch.Generator().manual_seed(seeds[i]))``, as ``train()``
initialises a solo model; so a member of a population equals a population of
one with the same seed (tests/test_torch_population.py).

Over a mesh of D ranks (``parallel/mesh.py``) rank r trains the contiguous
block of N/D members [r N/D, (r+1) N/D) with their own generators, so each
member follows the run it has in the solo population; with ``share_batch``
every rank also keeps member 0's generator, whose batches every member
trains on.  History records, validation records and the selection are
gathered from every rank, and every rank returns the whole population.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.parallel.train_step import shard_seed
from microwakeword_tpu_torch.train import metrics as M
from microwakeword_tpu_torch.train.loop import adam, flat_layout, loss_weights, weighted_bce

# the seed of a member's device generator: ``sample_seed`` in the high 32
# bits, the member's ``seed`` in the low 32
member_seed = shard_seed


def init_population(bundle, seeds, device=None) -> dict:
    """Stacked state: every parameter and BatchNorm statistic of the module
    gains a leading [N] axis; member i is
    ``bundle.init(torch.Generator().manual_seed(seeds[i]))``."""
    dev = resolve_device(device)
    states = [bundle.init(torch.Generator().manual_seed(int(s)), device=dev).state_dict()
              for s in seeds]
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def member_variables(stacked: dict, i: int) -> dict:
    """Member i's state dict (views) from a stacked state."""
    return {k: v[i] for k, v in stacked.items()}


def _split_state(model: torch.nn.Module, state: dict) -> tuple[dict, dict]:
    """(parameters, BatchNorm statistics) of a state dict; the module's
    non-persistent buffers (MixConv's kernel masks) stay the template's."""
    params = {k: state[k] for k, _ in model.named_parameters()}
    return params, {k: v for k, v in state.items() if k not in params}


class PopulationTrainStep:
    """The member-batched train step (``make_population_train_step``).

    ``stacked`` (init_population's form) is copied: the parameters into one
    flat [N, P] vector (``flat``; ``params`` holds its [N, *shape] views), the
    BatchNorm statistics into ``buffers``.  ``generators`` are the members'
    device generators.  ``step(learning_rates, positive_class_weights,
    negative_class_weights, **masks)`` takes [N] tensors on the device and
    the SpecAugment sizes, runs ``steps`` (default steps_per_call) sub-steps
    on batches drawn from ``packed`` (a PackedTrainingData) and returns the
    last sub-step's metrics as [N] tensors.  ``step_on_features`` runs one
    sub-step on a given batch of features.
    """

    def __init__(self, bundle, stacked: dict, packed, batch_size: int, features_length: int,
                 generators, steps_per_call: int = 1, share_batch: bool = False,
                 lead_generator: torch.Generator | None = None):
        self.bundle = bundle
        self.packed = packed
        self.batch_size = int(batch_size)
        self.features_length = int(features_length)
        self.steps_per_call = int(steps_per_call)
        self.share_batch = bool(share_batch)
        self.generators = list(generators)
        # share_batch's batches: member 0's generator, which a rank without
        # member 0 keeps in step by drawing member 0's keep masks too
        self.lead = self.generators[0] if lead_generator is None else lead_generator
        first = next(iter(stacked.values()))
        self.device = first.device
        self.n = int(first.shape[0])
        if len(self.generators) != self.n:
            raise ValueError(f"{len(self.generators)} generators for {self.n} members")
        # the template module: functional_call swaps in each member's tensors
        self.model = bundle.build().to(self.device)
        params, buffers = _split_state(self.model, stacked)
        self.param_names = list(params)
        self.flat, views, self.grad, self.mu, self.nu, self.count = flat_layout(
            list(params.values()), (self.n,))
        self.params = dict(zip(self.param_names, views))
        self.buffers = {k: v.detach().clone() for k, v in buffers.items()}
        grad_fn = grad_and_value(self._loss, has_aux=True)
        # in_dims of (params, buffers, feats, labels, penalties, pos_w, neg_w,
        # keep mask) by (private batch, keep mask)
        self._grad_fns = {(x, k): vmap(grad_fn, in_dims=(0, 0, x, x, x, 0, 0, k))
                          for x in (0, None) for k in (0, None)}
        self._metrics = vmap(M.binary_metrics, in_dims=(0, None))
        self._metrics_private = vmap(M.binary_metrics)

    # ---- state ----------------------------------------------------------
    def state(self) -> dict:
        """The stacked state (views of the live tensors)."""
        return {**self.params, **self.buffers}

    # ---- one sub-step ---------------------------------------------------
    def _loss(self, params, buffers, feats, labels, penalties, pos_w, neg_w, keep):
        weights = loss_weights(penalties, labels, pos_w, neg_w)
        probs = functional_call(self.model, (params, buffers), (feats.to(self.flat.dtype), keep))
        return weighted_bce(probs, labels, weights), probs

    def _keep_masks(self) -> torch.Tensor | None:
        """[N, B, D] keep masks, one draw from each member's generator; None
        where the model draws none."""
        if self.lead is not self.generators[0]:
            self.model.keep_mask(self.batch_size, self.lead)
        keep = [self.model.keep_mask(self.batch_size, g) for g in self.generators]
        return None if keep[0] is None else torch.stack(keep)

    def _sample(self, masks: dict):
        """One population batch: (feats, labels, penalties, keep masks), the
        first three [B, ...] with share_batch, else [N, B, ...]."""
        b, length = self.batch_size, self.features_length
        if self.share_batch:
            feats, labels, pens = S.sample_batch(self.packed, self.lead, b, length, **masks)
            return feats, labels, pens, self._keep_masks()
        m = masks["time_mask_count"] + masks["freq_mask_count"]
        u_win, u_aug, keep = [], [], []
        for g in self.generators:  # each member's draws in a solo step's order
            u_win.append(S.window_uniforms(self.packed, g, b))
            if m:
                u_aug.append(torch.rand((b, 2 * m), generator=g, device=self.device))
            keep.append(self.model.keep_mask(b, g))
        off, n, start, labels, pens = S.windows_from_uniforms(self.packed, torch.cat(u_win),
                                                              length)
        windows, valid = S.gather_windows(self.packed.frames, off, n, start, length)
        feats = S.finish_batch(None, windows, valid)
        if m:
            u = torch.cat(u_aug)
            feats = S.spec_augment_from_uniforms(feats, u[:, :m], u[:, m:], **masks)
        return (feats.reshape((self.n, b) + feats.shape[1:]), labels.reshape(self.n, b),
                pens.reshape(self.n, b), None if keep[0] is None else torch.stack(keep))

    def _sub_step(self, feats, labels, pens, keep, neg_lr, pos_w, neg_w):
        fn = self._grad_fns[(0 if feats.dim() == 4 else None, None if keep is None else 0)]
        self.model.train()
        try:
            grads, (loss, probs) = fn(self.params, self.buffers, feats, labels, pens, pos_w,
                                      neg_w, keep)
        finally:
            self.model.eval()
        torch.cat([grads[k].reshape(self.n, -1) for k in self.param_names], dim=1, out=self.grad)
        with torch.no_grad():
            adam(self.flat, self.grad, self.mu, self.nu, self.count, neg_lr)
        return probs.detach(), labels, loss.detach()

    def _report(self, last) -> dict:
        probs, labels, loss = last
        fn = self._metrics_private if labels.dim() == 2 else self._metrics
        metrics = fn(probs, labels)
        metrics["loss"] = loss
        return metrics

    def _hyper(self, learning_rates, positive_class_weights, negative_class_weights):
        def dev(x):
            return torch.as_tensor(x, dtype=self.flat.dtype, device=self.device)

        return (-dev(learning_rates)).reshape(self.n, 1), dev(positive_class_weights), dev(
            negative_class_weights)

    def step(self, learning_rates, positive_class_weights, negative_class_weights,
             steps: int | None = None, time_mask_max_size: int = 0, time_mask_count: int = 0,
             freq_mask_max_size: int = 0, freq_mask_count: int = 0) -> dict:
        """``steps`` (default steps_per_call) sub-steps on drawn batches; the
        last sub-step's metrics, [N] tensors."""
        masks = dict(time_mask_max_size=time_mask_max_size, time_mask_count=time_mask_count,
                     freq_mask_max_size=freq_mask_max_size, freq_mask_count=freq_mask_count)
        hyper = self._hyper(learning_rates, positive_class_weights, negative_class_weights)
        for _ in range(self.steps_per_call if steps is None else steps):
            last = self._sub_step(*self._sample(masks), *hyper)
        return self._report(last)

    def step_on_features(self, feats, labels, penalties, learning_rates, positive_class_weights,
                         negative_class_weights, keep=None) -> dict:
        """One sub-step on given features: [B, L, F] shared by every member
        or [N, B, L, F] per member (labels and penalties [B] or [N, B]);
        ``keep`` the [N, B, D] keep masks where the model draws them
        (``_keep_masks``)."""
        hyper = self._hyper(learning_rates, positive_class_weights, negative_class_weights)
        return self._report(self._sub_step(feats, labels, penalties, keep, *hyper))


def make_population_train_step(bundle, packed, batch_size: int, features_length: int,
                               stacked: dict, generators, steps_per_call: int = 1,
                               share_batch: bool = False,
                               lead_generator: torch.Generator | None = None
                               ) -> PopulationTrainStep:
    """The member-batched step over ``packed`` for the population ``stacked``;
    see PopulationTrainStep."""
    return PopulationTrainStep(bundle, stacked, packed, batch_size, features_length, generators,
                               steps_per_call, share_batch, lead_generator)


def make_population_eval_fn(bundle, n_models: int, eval_batch: int = 512):
    """Chunked eval-mode forward of every member over shared data:
    (stacked state, x [M, L, F] tensor or array) -> numpy probabilities [N, M]."""
    model = bundle.build()
    forward = vmap(lambda p, b, x: functional_call(model, (p, b), (x,)), in_dims=(0, 0, None))

    @torch.inference_mode()
    def eval_probs(stacked: dict, x) -> np.ndarray:
        first = next(iter(stacked.values()))
        model.to(first.device).eval()
        params, buffers = _split_state(model, stacked)
        x = torch.as_tensor(x, dtype=first.dtype, device=first.device)
        outs = [forward(params, buffers, x[i : i + eval_batch]).reshape(n_models, -1)
                for i in range(0, x.shape[0], eval_batch)]
        if not outs:
            return np.zeros((n_models, 0), np.float32)
        return torch.cat(outs, dim=1).cpu().numpy()

    return eval_probs


def _per_member(values, default: float, n: int) -> np.ndarray:
    return np.asarray(values if values is not None else [default] * n, np.float32)


def train_population(
    bundle,
    packed,
    n_models: int,
    steps: int,
    batch_size: int,
    features_length: int,
    seeds=None,
    learning_rates=None,
    positive_class_weights=None,
    negative_class_weights=None,
    mesh=None,
    spec_augment: dict | None = None,
    eval_interval: int = 0,
    sample_seed: int = 1234,
    validation=None,
    ambient=None,
    ambient_hours: float = 0.0,
    minimization_metric: str | None = None,
    maximization_metric: str = "average_viable_recall",
    target_minimization: float = 0.9,
    steps_per_call: int = 1,
    share_batch: bool = False,
    device=None,
):
    """Trains a population on ``device`` (default the card); returns (stacked
    state, history[, selection]).

    history: {"step", "loss": [N], "accuracy": [N], ...} records every
    ``eval_interval`` steps and at the last step.  With ``validation=(val_x,
    val_y)`` (and optionally ``ambient`` windows and ``ambient_hours``), every
    record runs the members' validation pass and applies the two-step
    best-checkpoint rule (``metrics.is_new_best``) per member; the return
    gains {"best_variables": stacked best states on the CPU, "best_step":
    [N], "leaderboard": rows best first by (min metric <= target, max
    metric)}.  ``mesh`` (a ``parallel.mesh.Mesh`` or a rank count; None or
    1: one device) splits the members over its ranks; ``packed`` must then
    be the same corpus on every rank.
    """
    from microwakeword_tpu_torch.parallel.mesh import resolve_mesh

    dev = resolve_device(device)
    mesh = resolve_mesh(mesh, dev)
    seeds = list(seeds) if seeds is not None else list(range(n_models))
    if len(seeds) != n_models:
        raise ValueError(f"{len(seeds)} seeds for {n_models} members")
    # this rank's members: all of them on one device
    block = slice(0, n_models) if mesh is None else mesh.rows(n_models)
    if mesh is not None:
        dev = mesh.device
    n_local = block.stop - block.start
    lrs = _per_member(learning_rates, 0.001, n_models)
    pos_w = _per_member(positive_class_weights, 1.0, n_models)
    neg_w = _per_member(negative_class_weights, 1.0, n_models)
    hyper = tuple(torch.from_numpy(v[block]).to(dev) for v in (lrs, pos_w, neg_w))
    sa = {"time_mask_max_size": 0, "time_mask_count": 0, "freq_mask_max_size": 0,
          "freq_mask_count": 0, **(spec_augment or {})}

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(member_seed(sample_seed, seed))

    lead = generator(seeds[0]) if share_batch and block.start > 0 else None
    pop = make_population_train_step(bundle, packed, batch_size, features_length,
                                      init_population(bundle, seeds[block], dev),
                                      [generator(s) for s in seeds[block]], steps_per_call,
                                      share_batch, lead)

    def gathered(local: list) -> list:
        """Every rank's list of per-member values, concatenated."""
        return local if mesh is None else sum(mesh.all_gather_object(local), [])

    select = validation is not None
    best = None
    if select:
        val_x = torch.as_tensor(np.asarray(validation[0], np.float32), device=dev)
        val_y = np.asarray(validation[1], np.float32).reshape(-1)
        amb_x = (torch.as_tensor(np.asarray(ambient, np.float32), device=dev)
                 if ambient is not None and len(ambient) else None)
        eval_probs = make_population_eval_fn(bundle, n_local)
        best = {"min": np.full(n_local, 10000.0), "max": np.zeros(n_local),
                "step": np.zeros(n_local, np.int64), "metrics": [None] * n_local,
                "state": None}

    def run_selection(step: int) -> list:
        vp = eval_probs(pop.state(), val_x)  # [N, M]
        ap = eval_probs(pop.state(), amb_x) if amb_x is not None else None
        improved, records = [], []
        for i in range(n_local):
            vm = M.validation_metrics(vp[i], val_y, ap[i] if ap is not None else None,
                                      ambient_hours)
            records.append(vm)
            cur_min = float(vm[minimization_metric]) if minimization_metric else 0.0
            cur_max = float(vm[maximization_metric])
            if M.is_new_best(cur_min, cur_max, best["min"][i], best["max"][i],
                             target_minimization):
                best["min"][i], best["max"][i], best["step"][i] = cur_min, cur_max, step
                best["metrics"][i] = vm
                improved.append(i)
        # the first improvement of any member snapshots every member
        any_improved = any(gathered([bool(improved)]))
        if best["state"] is None and any_improved or improved:
            # snapshot the improved members' weights on the host (they are small)
            host = {k: v.detach().to("cpu", copy=True) for k, v in pop.state().items()}
            if best["state"] is None:
                best["state"] = host
            else:
                idx = torch.as_tensor(improved)
                for k, v in best["state"].items():
                    v[idx] = host[k][idx]
        return gathered(records)

    history = []
    step = 0
    while step < steps:
        # chain sub-steps only up to the next record, so the recorded
        # trajectory equals the unchained loop's
        boundary = (min(steps, step + eval_interval - step % eval_interval) if eval_interval
                    else steps)
        n = steps_per_call if boundary - step >= steps_per_call else 1
        metrics = pop.step(*hyper, steps=n, **sa)
        step += n
        if (eval_interval and step % eval_interval == 0) or step == steps:
            if mesh is not None:
                metrics = {k: mesh.gather_rows(v) for k, v in metrics.items()}
            record = {"step": step} | {k: v.cpu().numpy() for k, v in metrics.items()}
            if select:
                record["validation"] = run_selection(step)
            history.append(record)

    stacked = {k: v.detach().clone() for k, v in pop.state().items()}
    if mesh is not None:
        stacked = {k: mesh.gather_rows(v) for k, v in stacked.items()}
    if not select:
        return stacked, history
    if best["state"] is None:  # no eval improved on the initial bounds
        best["state"] = {k: v.detach().to("cpu", copy=True) for k, v in pop.state().items()}
    if mesh is not None:
        parts = mesh.all_gather_object({k: best[k] for k in ("min", "max", "step", "state")})
        for k in ("min", "max", "step"):
            best[k] = np.concatenate([p[k] for p in parts])
        best["state"] = {k: torch.cat([p["state"][k] for p in parts]) for k in best["state"]}
        best["metrics"] = gathered(best["metrics"])
    order = sorted(range(n_models), key=lambda i: (
        0 if best["min"][i] <= target_minimization else 1, -best["max"][i], best["min"][i]))
    leaderboard = [
        {"member": i, "seed": seeds[i], "learning_rate": float(lrs[i]),
         "best_step": int(best["step"][i]), "minimization": float(best["min"][i]),
         "maximization": float(best["max"][i]), "metrics": best["metrics"][i]}
        for i in order
    ]
    selection = {"best_variables": best["state"], "best_step": best["step"],
                 "leaderboard": leaderboard}
    return stacked, history, selection
