"""Traffic kind ``train``: the program's train step driven back to back.

Set-up makes the corpus and the initial weights from the seed, packs the
corpus with the program's own packing functions (``sampler.pack_audio_data``
for raw audio, ``sampler.pack_training_data`` for spectrograms), builds one
``TrainStep`` (``train.loop.make_train_step``) with a generator of its own
seed, and drives it through its first ``checked_steps`` steps, keeping the
losses, the features its model consumed in each step (read as the step
hands them to its model), Adam's first moment after step 1 and the
parameters before and after; then ``warmup_steps`` more.  The window
enqueues ``step(**phase)`` as ``train()`` does, with no host sync, until
``seconds`` have passed on the host's clock, then synchronises.  Each step
is enqueued behind a gate (``benchmark.lib.gate``) and let go once it is
whole: ``train_step_device_ms`` is the card's time of all the window's steps,
on CUDA events, over the steps: what a step costs the card with the host's
pace taken out.  Clips per second on the host's clock (steps x batch over
the time up to the sync) is the per-layer ``clips_per_s.train``: the host
launches the step's kernels one by one, and a shared host's stalls move it
by more than a bound can hold (PERF.md).

The workload file gives the corpus (``corpus``: kind, providers, clip
counts and lengths), the recipe (``recipe``), the step counts and the
limits of the numbers compared.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark.lib import compare, inputs, program
from benchmark.lib.cell import module
from benchmark.lib.clock import sync_fn, timer_ms
from benchmark.lib.gate import Gate
from benchmark.lib.profile import profile
from benchmark.reference import frontend as RF
from benchmark.reference import training as RT

MASK_KEYS = ("time_mask_max_size", "time_mask_count", "freq_mask_max_size", "freq_mask_count")
PHASE_KEYS = ("learning_rate", *MASK_KEYS, "positive_class_weight", "negative_class_weight")


class _AudioProvider:
    """A clips-type provider as ``sampler.pack_audio_data`` reads one."""

    def __init__(self, spec: dict, clips: np.ndarray):
        self.sampling_weight = spec["sampling_weight"]
        self.label = spec["label"]
        self.penalty_weight = spec["penalty_weight"]
        self.truncation_strategy = spec["truncation_strategy"]
        self.clips = clips

    def generate_audio_pool(self, shard_index: int = 0, shard_count: int = 1):
        return iter(self.clips[shard_index::shard_count])


class _Store:
    def __init__(self, data: np.ndarray, offsets: np.ndarray):
        self.data, self.offsets = data, offsets

    def __len__(self) -> int:
        return len(self.offsets) - 1


class _SpectrogramProvider:
    """An mmap-type provider as ``sampler.pack_training_data`` reads one."""

    def __init__(self, spec: dict, data: np.ndarray, offsets: np.ndarray):
        self.sampling_weight = spec["sampling_weight"]
        self.label = spec["label"]
        self.penalty_weight = spec["penalty_weight"]
        self.truncation_strategy = spec["truncation_strategy"]
        self.fixed_right_cutoffs = list(spec.get("fixed_right_cutoffs", []))
        self.stores = {"training": [_Store(data, offsets)]}


def _frontend_launches() -> int:
    from microwakeword_tpu_torch.frontend import frontend_batch

    return frontend_batch.launches


class Traffic:
    def __init__(self, cell, dev: torch.device):
        self.cell, self.dev = cell, dev
        self.w = cell.workload
        self.recipe = self.w["recipe"]
        self.phase = {k: self.recipe[k] for k in PHASE_KEYS}
        self.sync = sync_fn(dev)
        self.ref = module("reference", cell.family)
        self.model_cfg = cell.config["model"]

    # ---- set-up ---------------------------------------------------------
    def _corpus(self):
        """The raw corpus from the seed: the reference's providers and the
        program's."""
        corpus = self.w["corpus"]
        gen = inputs.generator(self.cell.sub_seed(1), self.dev)
        ref, prog = [], []
        for spec in corpus["providers"]:
            positive = spec["label"] > 0.5
            if corpus["kind"] == "audio":
                samples = int(round(spec["clip_seconds"] * inputs.SAMPLE_RATE))
                clips = inputs.pcm_clips(gen, spec["clips"], samples, positive, self.dev)
                clips = clips.cpu().numpy()
                prog.append(_AudioProvider(spec, clips))
                ref.append(RT.Provider(spec["label"], spec["penalty_weight"],
                                       spec["sampling_weight"], spec["truncation_strategy"], clips))
            else:
                data, offsets = inputs.spectrogram_corpus(gen, spec["clips"], tuple(spec["frames"]),
                                                          positive, corpus["features"], self.dev)
                prog.append(_SpectrogramProvider(spec, data, offsets))
                ref.append(RT.Provider(spec["label"], spec["penalty_weight"],
                                       spec["sampling_weight"], spec["truncation_strategy"], data,
                                       offsets, tuple(spec.get("fixed_right_cutoffs", ()))))
        self.ref_corpus = {"kind": corpus["kind"], "providers": ref,
                           "step_ms": self.cell.config["window_step_ms"],
                           "scale": corpus.get("feature_scale", 0.0390625)}
        return prog

    def setup(self) -> None:
        from microwakeword_tpu_torch.data import sampler
        from microwakeword_tpu_torch.train import loop

        providers = self._corpus()
        wgen = inputs.generator(self.cell.sub_seed(2), self.dev)
        self.state = inputs.weights(self.ref.state_shapes(self.model_cfg), wgen, self.dev,
                                    serving=False)
        self.bundle = program.bundle(self.cell)
        model = self.bundle.load(self.state, self.dev)
        step_ms = self.cell.config["window_step_ms"]
        if self.w["corpus"]["kind"] == "audio":
            self.packed = sampler.pack_audio_data(providers, self.dev, step_ms=step_ms)
        else:
            self.packed = sampler.pack_training_data(providers, self.dev)
        del providers
        self.gen_seed = self.cell.sub_seed(3)
        self.step = loop.make_train_step(
            self.bundle, model, self.packed, self.recipe["batch_size"],
            self.model_cfg["spectrogram_length"], 1,
            torch.Generator(device=self.dev).manual_seed(self.gen_seed))
        self.names = [n for n, _ in model.named_parameters()]
        self.sizes = [p.numel() for p in model.parameters()]
        # the checked steps: the window's own call on the window's feed, with
        # the features each step hands its model kept on the way
        flat0 = self.step.flat.detach().clone()
        losses, feats = [], []
        sub_step = self.step._sub_step

        def keep_features(f, *args, **kwargs):
            feats.append(f.detach().clone())
            return sub_step(f, *args, **kwargs)

        self.step._sub_step = keep_features
        try:
            for i in range(self.w["checked_steps"]):
                losses.append(self.step.step(**self.phase)["loss"])
                if i == 0:
                    mu1 = self.step.mu.detach().clone()
        finally:
            del self.step._sub_step
        self.checked = {"losses": [float(x) for x in losses],
                        "grads": self._leaves(mu1 / (1.0 - self.recipe["optimizer"]["b1"])),
                        "change": self._leaves(self.step.flat.detach() - flat0),
                        "feats": [f.cpu() for f in feats]}
        for _ in range(self.w["warmup_steps"]):
            self.step.step(**self.phase)
        self.sync()

    def _leaves(self, flat: torch.Tensor) -> dict:
        return {n: v.to("cpu", torch.float64)
                for n, v in zip(self.names, torch.split(flat.detach(), self.sizes))}

    # ---- the window -----------------------------------------------------
    def window(self, seconds: float):
        step, phase = self.step, self.phase
        # set-up's steps made every first call and filled the allocator's cache: inside a
        # held step either would wait for the card
        gate = Gate(self.dev)
        self.sync()
        t0 = time.perf_counter()
        n = 0
        while True:
            with gate.unit():
                last = step.step(**phase)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        gate.close()
        self.sync()
        self.window_s = time.perf_counter() - t0
        self.window_steps = n
        self.device_s = sum(gate.unit_ms()) / 1e3
        failed = 0 if bool(torch.isfinite(last["loss"])) else 1
        self.clips_per_s = n * self.recipe["batch_size"] / self.window_s
        print(f"window: {n} steps in {self.window_s!r} s, {self.clips_per_s!r} clips/s on the "
              f"host's clock, {self.device_s!r} s of gated steps", file=sys.stderr)
        return {"train_step_device_ms": 1e3 * self.device_s / n}, n, failed

    # ---- the traced slice ------------------------------------------------
    def trace(self):
        from microwakeword_tpu_torch.data import sampler

        step, phase, n = self.step, self.phase, self.w["profiled_steps"]

        def steps():
            for _ in range(n):
                step.step(**phase)

        launches = _frontend_launches()
        tr = profile(steps, n, self.sync)
        launches = _frontend_launches() - launches
        batch, length = self.recipe["batch_size"], self.model_cfg["spectrogram_length"]
        masks = {k: phase[k] for k in MASK_KEYS}
        gen = torch.Generator(device=self.dev).manual_seed(self.cell.sub_seed(4))

        def sample():
            sampler.sample_any(self.packed, gen, batch, length, **masks)

        for _ in range(2):
            sample()
        self.sync()
        tr.spans["sample"] = [timer_ms(self.dev, sample) for _ in range(self.w["sampler_batches"])]
        flops = module("counts", self.cell.family).forward_flops(self.model_cfg)
        tr.counts.update(mfu_flops=3.0 * flops * batch * self.window_steps,
                         mfu_s=self.device_s, clips_per_s=self.clips_per_s)
        if self.w["corpus"]["kind"] == "audio":
            # one call per step on the window's hops: frames + ceil(480 / hop) - 1
            hop = self.packed.hop_samples
            samples = (length + math.ceil(RF.WINDOW / hop) - 1) * hop
            tr.counts.update(frontend_batch=batch, frontend_samples=samples,
                             frontend_step_ms=self.cell.config["window_step_ms"],
                             frontend_calls=n,
                             frontend_launches=launches)
        return tr

    def free(self) -> None:
        for name in ("step", "packed", "bundle"):
            setattr(self, name, None)

    # ---- correctness -----------------------------------------------------
    def reference(self, dtype=torch.float64, half_batch: bool = False, feats_in=None) -> dict:
        return RT.train(self.ref, self.model_cfg, self.state, self.ref_corpus, self.recipe,
                        self.gen_seed, self.w["checked_steps"], self.dev, dtype, half_batch,
                        feats_in)

    def judge(self, got: dict) -> dict:
        """The numbers compared, stage by stage:

        - ``feature_mismatch``: the share of the checked steps' feature cells
          (the sampler's stage: draws, windows, the frontend for raw audio,
          SpecAugment) whose level differs from the reference's;
        - ``loss_gap``: the first step's loss, ``grad_gap``: the median
          leaf's gap of norms of the first gradient, ``change_gap``: of the
          parameters' change over the checked steps (the model's stage:
          forward, weighted BCE, backward, Adam), against the reference in
          float64 on its own features merged with ``got``'s (reference
          ``frontend.merge``).

        Later steps' losses and the worst leaf are left out: float32
        rounding of near-zero gradients, which Adam turns into whole steps,
        and the cancellation in a BatchNorm scale's gradient move them in a
        plain float32 reference as much as in the program (PERF.md, "How
        correct is decided")."""
        want = self.reference(feats_in=got["feats"])
        moving = compare.moving_leaves(want["grads"])
        return {
            "feature_mismatch": compare.level_mismatch(got["feats"], want["feats"]),
            "loss_gap": compare.relative_gap(got["losses"][0], want["losses"][0]),
            "grad_gap": compare.median_leaf_gap(got["grads"], want["grads"]),
            "change_gap": compare.median_leaf_gap(got["change"], want["change"], moving),
        }

    def readings(self) -> dict:
        return self.judge(self.checked)
