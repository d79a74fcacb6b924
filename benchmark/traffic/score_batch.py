"""Traffic kind ``score_batch``: a closed loop of scoring requests, each a
batch of streams of int16 PCM on the card, scored as a host that serves many
microphone streams scores them, and as the streamed false-accept scan of the
ROC counts them:

- ``frontend_batch`` (the frontend kernel) over the batch,
- ``ModelBundle.stream_scan`` over the features,
- ``ambient_accept_counts`` over the streamed probabilities (the ROC's
  default cutoffs, the workload's sliding window and cooldown), the counts
  back on the host.

The next request starts when the last one's counts are back.  The batches
are a pool of ``pool`` distinct ones made from the seed in set-up, cycled.
Audio-seconds scored per second is the requests' audio over the window's
time up to the last request's end.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import compare, inputs, program
from benchmark.lib.cell import module
from benchmark.lib.clock import sync_fn, timer_ms
from benchmark.lib.profile import profile
from benchmark.reference import accepts as RA
from benchmark.reference import frontend as RF


class Traffic:
    def __init__(self, cell, dev: torch.device):
        self.cell, self.dev = cell, dev
        self.w = cell.workload
        self.sync = sync_fn(dev)
        self.ref = module("reference", cell.family)
        self.model_cfg = cell.config["model"]
        self.step_ms = cell.config["window_step_ms"]

    def setup(self) -> None:
        from microwakeword_tpu_torch.evaluate import roc

        w = self.w
        gen = inputs.generator(self.cell.sub_seed(1), self.dev)
        samples = int(round(w["stream_seconds"] * inputs.SAMPLE_RATE))
        self.pool = [inputs.pcm_clips(gen, w["streams"], samples, i % 2 == 0, self.dev)
                     for i in range(w["pool"])]
        wgen = inputs.generator(self.cell.sub_seed(2), self.dev)
        self.state = inputs.weights(self.ref.state_shapes(self.model_cfg), wgen, self.dev,
                                    serving=True)
        self.bundle = program.bundle(self.cell)
        self.model = self.bundle.load(self.state, self.dev)
        self.cutoffs = roc.DEFAULT_CUTOFFS
        self.audio_s = w["streams"] * w["stream_seconds"]
        self.checked_ids, self.features = set(), {}
        self.kept = []  # (pool index, probs [streams, steps] on the device, counts)
        for i in range(w["warmup_requests"]):
            self._request(i % len(self.pool))
        self.kept.clear()
        # the requests whose features are kept for the check, drawn from the
        # seed among the pool's first turn
        rng = np.random.default_rng(self.cell.sub_seed(5))
        n = len(self.pool)
        self.checked_ids = set(rng.choice(n, size=min(w["checked_requests"], n),
                                          replace=False).tolist())
        self.sync()

    def _score(self, pcm):
        """The request's three calls: (features, probabilities, counts)."""
        from microwakeword_tpu_torch.evaluate.streaming_eval import ambient_accept_counts
        from microwakeword_tpu_torch.frontend import frontend_batch

        w = self.w
        feats = frontend_batch(pcm, self.step_ms)
        probs = self.bundle.stream_scan(self.model, feats)[..., 0]
        counts, _ = ambient_accept_counts([probs], self.cutoffs, w["ignore_slices_after_accept"],
                                          w["sliding_window"], stride=self.bundle.stride,
                                          step_s=self.step_ms / 1000.0)
        return feats, probs, counts

    def _request(self, i: int):
        feats, probs, counts = self._score(self.pool[i])
        if len(self.kept) in self.checked_ids:
            self.features[len(self.kept)] = feats
        self.kept.append((i, probs, counts))

    def window(self, seconds: float):
        self.sync()
        t0 = time.perf_counter()
        n = failed = 0
        while time.perf_counter() - t0 < seconds:
            try:
                self._request(n % len(self.pool))
            except RuntimeError:
                failed += 1
            n += 1
        self.window_s = time.perf_counter() - t0
        failed += sum(1 for _, probs, _ in self.kept if not bool(torch.isfinite(probs).all()))
        return {"score_audio_s_per_s": len(self.kept) * self.audio_s / self.window_s}, n, failed

    def trace(self):
        w = self.w
        pcm = self.pool[0]
        out = {}

        def request():
            with torch.profiler.record_function("bench.frontend"):
                from microwakeword_tpu_torch.frontend import frontend_batch

                feats = frontend_batch(pcm, self.step_ms)
            with torch.profiler.record_function("bench.stream_scan"):
                probs = self.bundle.stream_scan(self.model, feats)[..., 0]
            with torch.profiler.record_function("bench.accepts"):
                from microwakeword_tpu_torch.evaluate.streaming_eval import ambient_accept_counts

                out["counts"] = ambient_accept_counts(
                    [probs], self.cutoffs, w["ignore_slices_after_accept"], w["sliding_window"],
                    stride=self.bundle.stride, step_s=self.step_ms / 1000.0)
            out["probs"] = probs

        from microwakeword_tpu_torch.frontend import frontend_batch

        launches = frontend_batch.launches
        tr = profile(request, 1, self.sync)
        launches = frontend_batch.launches - launches
        steps = out["probs"].shape[1]

        def accepts():
            from microwakeword_tpu_torch.evaluate.streaming_eval import ambient_accept_counts

            ambient_accept_counts([out["probs"]], self.cutoffs, w["ignore_slices_after_accept"],
                                  w["sliding_window"], stride=self.bundle.stride,
                                  step_s=self.step_ms / 1000.0)

        tr.spans["accept"] = [timer_ms(self.dev, accepts) for _ in range(w["accept_probes"])]
        flops = module("counts", self.cell.family).stream_step_flops(self.model_cfg)
        tr.counts.update(stream_steps=steps,
                         mfu_flops=flops * steps * w["streams"] * len(self.kept),
                         mfu_s=self.window_s, frontend_batch=w["streams"],
                         frontend_samples=pcm.shape[1], frontend_step_ms=self.step_ms,
                         frontend_calls=1, frontend_launches=launches)
        return tr

    def free(self) -> None:
        self.model = self.bundle = None

    # ---- correctness -----------------------------------------------------
    def _state(self, dtype):
        return {k: v.to(dtype) for k, v in self.state.items()}

    def readings(self, dtype=torch.float64, control=False) -> dict:
        """Stage by stage, on the requests drawn for the check:

        - ``feature_mismatch``: the share of feature cells whose level
          differs from the reference frontend's over the same PCM (a Q6
          level that flips on a last-bit difference, which the frontend's
          gate allows, counts too);
        - ``prob_gap``: the widest gap between a streamed probability and
          the reference model's over the reference frontend's features,
          with the program's value at each cell whose level differs
          (reference ``frontend.merge``);
        - ``count_mismatch``: over every request, the cutoffs whose accept
          count differs from the reference's count over that request's
          probabilities (exact).

        With ``control`` the reference computed in ``dtype`` stands in the
        program's place: its frontend over the PCM and its model over its
        own features."""
        w, got_feats, want_feats, gap, mismatch = self.w, [], [], 0.0, 0
        want_state, got_state = self._state(torch.float64), self._state(dtype)
        for j, feats in sorted(self.features.items()):
            i, probs, _ = self.kept[j]
            want = RF.features(self.pool[i], self.step_ms)
            if control:
                feats = RF.features(self.pool[i], self.step_ms, dtype)
                probs = self.ref.stream_probs(got_state, self.model_cfg, feats)
            ref = self.ref.stream_probs(want_state, self.model_cfg, RF.merge(want, feats))
            gap = max(gap, float((probs.double() - ref).abs().max()))
            got_feats.append(feats)
            want_feats.append(want)
        if not self.features:  # none of the drawn requests was answered
            gap = float("inf")
        if not control:
            for _, probs, counts in self.kept:
                ma = RA.sliding_mean(probs.cpu().numpy(), w["sliding_window"])
                want = RA.accept_counts(ma, self.cutoffs, w["ignore_slices_after_accept"]).sum(0)
                mismatch += int((np.asarray(counts) != want).sum())
        return {"feature_mismatch": compare.level_mismatch(got_feats, want_feats),
                "prob_gap": gap, "count_mismatch": float(mismatch)}
