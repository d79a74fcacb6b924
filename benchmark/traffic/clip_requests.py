"""Traffic kind ``clip_requests``: one client in a closed loop sends one int16
clip per request to ``Model.from_torch(bundle, state).predict_clip`` and
waits for its probabilities on the host.

The clips are a pool made from the seed in set-up, held on the host as a
server holds what it received.  Their lengths are ``strata`` values evenly
spaced over ``seconds`` (least, most), ``per_stratum`` clips of each; the
requests go in blocks of ``strata``, each block one clip of every length in
an order drawn from the seed, so that every seed sends the same lengths.
A request's latency is the host's clock from the call to the returned
probabilities; a request that raises, or returns probabilities that are not
finite, has failed and counts as never answered.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import inputs, program
from benchmark.lib.cell import module
from benchmark.lib.clock import sync_fn
from benchmark.lib.profile import profile
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
        from microwakeword_tpu_torch.inference import Model

        w = self.w
        lo, hi = (int(round(s * inputs.SAMPLE_RATE)) for s in w["seconds"])
        strata, per = w["strata"], w["per_stratum"]
        lengths = np.round(np.linspace(lo, hi, strata)).astype(int)
        gen = inputs.generator(self.cell.sub_seed(1), self.dev)
        audio = inputs.pcm_clips(gen, strata * per, hi, True, self.dev).cpu().numpy()
        # clip s * per + b has stratum s's length
        self.clips = [audio[i, :lengths[i // per]].copy() for i in range(strata * per)]
        rng = np.random.default_rng(self.cell.sub_seed(6))
        self.order = np.concatenate([s * per + b for b, s in
                                     ((b, rng.permutation(strata)) for b in range(per))])
        wgen = inputs.generator(self.cell.sub_seed(2), self.dev)
        self.state = inputs.weights(self.ref.state_shapes(self.model_cfg), wgen, self.dev,
                                    serving=True)
        self.model = Model.from_torch(program.bundle(self.cell), self.state, self.dev)
        self.sent = 0
        for _ in range(w["warmup_requests"]):
            self._request()
        self.sync()
        self.answers = []  # (clip index, probabilities or None, seconds)

    def _request(self):
        i = int(self.order[self.sent % len(self.order)])
        self.sent += 1
        t0 = time.perf_counter()
        try:
            probs = self.model.predict_clip(self.clips[i], step_ms=self.step_ms)
        except RuntimeError:
            probs = None
        return i, probs, time.perf_counter() - t0

    def window(self, seconds: float):
        self.answers = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.answers.append(self._request())
        self.window_s = time.perf_counter() - t0
        lat = np.array([dt if p is not None and np.isfinite(p).all() else np.inf
                        for _, p, dt in self.answers])
        failed = int(np.isinf(lat).sum())
        p95 = float(np.percentile(lat, 95)) * 1e3
        return {"clip_latency_p95_ms": p95}, len(self.answers), failed

    def trace(self):
        n = self.w["profiled_requests"]

        def requests():
            for _ in range(n):
                with torch.profiler.record_function("bench.request"):
                    self._request()

        tr = profile(requests, n, self.sync)
        flops = module("counts", self.cell.family).stream_step_flops(self.model_cfg)
        stride = self.ref.stride(self.model_cfg)
        steps = sum(RF.num_frames(len(self.clips[i]), self.step_ms) // stride
                    for i, p, _ in self.answers if p is not None)
        tr.counts.update(mfu_flops=flops * steps, mfu_s=self.window_s)
        return tr

    def free(self) -> None:
        self.model = None

    # ---- correctness -----------------------------------------------------
    def reference_probs(self, i: int, dtype=torch.float64) -> torch.Tensor:
        state = {k: v.to(dtype) for k, v in self.state.items()}
        pcm = torch.as_tensor(self.clips[i][None], device=self.dev)
        return self.ref.stream_probs(state, self.model_cfg, RF.features(pcm, self.step_ms, dtype))[0]

    def sampled(self) -> list:
        """A sample of ``checked_requests`` answers drawn from the seed, with
        a longest clip's answer in it."""
        rng = np.random.default_rng(self.cell.sub_seed(5))
        n = len(self.answers)
        pick = set(rng.choice(n, size=min(self.w["checked_requests"], n), replace=False).tolist())
        longest = max(range(n), key=lambda j: len(self.clips[self.answers[j][0]]))
        return sorted(pick | {longest})

    def _gaps(self, dtype, control: bool):
        """|probability - reference| of every sampled answer, concatenated;
        None where an answer never came or has another length."""
        gaps = []
        for j in self.sampled():
            i, probs, _ = self.answers[j]
            want = self.reference_probs(i).cpu().numpy()
            if control:
                probs = self.reference_probs(i, dtype).cpu().numpy()
            if probs is None or len(probs) != len(want):
                return None
            gaps.append(np.abs(np.asarray(probs, np.float64) - want))
        return np.concatenate(gaps)

    def readings(self, dtype=torch.float64, control=False) -> dict:
        """``prob_mean_gap``: the mean gap between the probabilities that the
        sampled requests returned and the reference's from the same clips
        (infinite where an answer never came).  The widest gap is left out:
        a Q6 level of the frontend that flips on a last-bit difference,
        which the frontend's gate allows, moves a feature by up to 5.2 and
        reaches tens of steps' probabilities (PERF.md).  With ``control``
        the reference computed in ``dtype`` stands in the program's place."""
        gaps = self._gaps(dtype, control)
        return {"prob_mean_gap": float("inf") if gaps is None else float(gaps.mean())}
