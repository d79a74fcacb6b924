"""The plain reference of one training step of the notebook's recipe.

Batch assembly is microWakeWord's: a provider per row by its sampling
weight, a clip of it uniformly, a window of the clip by the provider's
truncation strategy (right-aligned behind zeros when the clip is shorter),
features (for raw audio the micro-frontend over the window, its noise
estimate from zero), SpecAugment's time and frequency masks; then weighted
binary cross-entropy on the probabilities and Adam.

The draws are uniforms from a ``torch.Generator`` seeded as the program's,
taken in the program's order per step: the window draw [B, P + 2] (raw
audio: provider, clip, start) or [B, P + 3] (spectrograms: provider, clip,
start, cutoff), then SpecAugment's [B, 2m], then the dropout keep mask
[B, width] where the model has a dropout.  The provider is the Gumbel-max of
log weight - log(-log u), an index floor(u * count) in float32.  Everything
else is worked out here from the raw clips the benchmark made.

``train`` checks the two stages of a step apart when it is handed the
features the program's model consumed (``feats_in``): it returns its own
features (the sampler's stage: draws, windows, frontend, SpecAugment) for a
comparison level by level, and its model stage takes its own features
except at the cells whose level differs from the program's, where it takes
the program's value (``frontend.merge``).  The frontend may flip a Q6 level
on a last-bit difference; the flip counts against the sampler's stage, and
the model's stage is then judged on the batch that the model was given.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference import frontend as RF

@dataclasses.dataclass
class Provider:
    label: float
    penalty: float
    weight: float
    strategy: str
    data: np.ndarray  # raw audio: [clips, samples] int16; spectrograms: [frames, F] uint16
    offsets: np.ndarray | None = None  # spectrograms: [clips + 1] frame offsets
    cutoffs: tuple = ()

    @property
    def count(self) -> int:
        return len(self.offsets) - 1 if self.offsets is not None else self.data.shape[0]

    def length(self, i: int) -> int:
        if self.offsets is not None:
            return int(self.offsets[i + 1] - self.offsets[i])
        return self.data.shape[1]

    def clip(self, i: int) -> np.ndarray:
        if self.offsets is not None:
            return self.data[self.offsets[i]:self.offsets[i + 1]]
        return self.data[i]


def _choose(providers, u: torch.Tensor):
    """Provider and clip of each row from the first P + 1 uniforms."""
    p = len(providers)
    logits = torch.as_tensor(np.log([pr.weight for pr in providers]).astype(np.float32),
                             device=u.device)
    prov = torch.argmax(logits - torch.log(-torch.log(u[:, :p])), dim=1)
    counts = torch.as_tensor([pr.count for pr in providers], dtype=torch.float32, device=u.device)
    clip = torch.minimum(torch.floor(u[:, p] * counts[prov]), counts[prov] - 1)
    return prov.cpu().numpy(), clip.to(torch.int64).cpu().numpy()


def _start(pr: Provider, n: int, length: int, u_win: float, u_cut: float) -> int:
    """The window's first row within a clip of n rows (negative: zeros first)."""
    if n <= length:
        return n - length
    if pr.strategy == "truncate_start":
        return n - length
    if pr.strategy == "truncate_end":
        return 0
    if pr.strategy == "fixed_right_cutoff":
        if not pr.cutoffs:
            return n - length
        cut = pr.cutoffs[min(int(np.floor(np.float32(u_cut) * np.float32(len(pr.cutoffs)))),
                             len(pr.cutoffs) - 1)]
        return n - length - cut
    return int(np.floor(np.float32(u_win) * np.float32(max(n - length, 1))))


def _window(rows: np.ndarray, start: int, length: int) -> np.ndarray:
    out = np.zeros((length,) + rows.shape[1:], rows.dtype)
    lo, hi = max(start, 0), min(start + length, len(rows))
    if hi > lo:
        out[lo - start:hi - start] = rows[lo:hi]
    return out


def draw_audio(providers, gen, batch: int, frames: int, step_ms: int, device):
    """Raw-audio rows: (PCM [B, (frames + 2) * hop] int16, labels, penalties).
    Clips are held as whole hops of ``step_ms``, at least one frontend window."""
    hop = RF.hop_samples(step_ms)
    span = frames + math.ceil(RF.WINDOW / hop) - 1  # hops under ``frames`` frames
    u = torch.rand((batch, len(providers) + 2), generator=gen, device=device)
    prov, clip = _choose(providers, u)
    u_win = u[:, len(providers) + 1].cpu().numpy()
    pcm, labels, penalties = [], [], []
    for b in range(batch):
        pr = providers[prov[b]]
        samples = pr.clip(clip[b])
        n = max(math.ceil(len(samples) / hop), math.ceil(RF.WINDOW / hop))
        hops = _window(np.pad(samples, (0, n * hop - len(samples))).reshape(n, hop),
                       _start(pr, n, span, u_win[b], 0.0), span)
        pcm.append(hops.reshape(-1))
        labels.append(pr.label)
        penalties.append(pr.penalty)
    return (torch.as_tensor(np.stack(pcm), device=device),
            torch.tensor(labels, device=device), torch.tensor(penalties, device=device))


def draw_spectrograms(providers, gen, batch: int, frames: int, scale: float, device, dtype):
    """Spectrogram rows: (features [B, frames, F] in ``dtype``, labels, penalties)."""
    p = len(providers)
    u = torch.rand((batch, p + 3), generator=gen, device=device)
    prov, clip = _choose(providers, u)
    u_win, u_cut = u[:, p + 1].cpu().numpy(), u[:, p + 2].cpu().numpy()
    rows, labels, penalties = [], [], []
    for b in range(batch):
        pr = providers[prov[b]]
        n = pr.length(clip[b])
        rows.append(_window(pr.clip(clip[b]), _start(pr, n, frames, u_win[b], u_cut[b]), frames))
        labels.append(pr.label)
        penalties.append(pr.penalty)
    feats = torch.as_tensor(np.stack(rows).astype(np.float64), device=device).to(dtype) * scale
    return feats, torch.tensor(labels, device=device), torch.tensor(penalties, device=device)


def spec_augment(gen, feats: torch.Tensor, time_max: int, time_count: int, freq_max: int,
                 freq_count: int) -> torch.Tensor:
    """Per row ``time_count`` time masks then ``freq_count`` frequency masks:
    size floor(u * max), start floor(u' * (dim - size + 1)), zeroed."""
    m = time_count + freq_count
    if m == 0:
        return feats
    u = torch.rand((feats.shape[0], 2 * m), generator=gen, device=feats.device)
    keep = torch.ones(feats.shape, dtype=torch.bool, device=feats.device)
    for j in range(m):
        time = j < time_count
        dim = feats.shape[1] if time else feats.shape[2]
        size = torch.floor(u[:, j] * (time_max if time else freq_max)).to(torch.int64)
        start = torch.floor(u[:, m + j] * (dim - size + 1).to(torch.float32)).to(torch.int64)
        idx = torch.arange(dim, device=feats.device)
        inside = (idx >= start[:, None]) & (idx < (start + size)[:, None])
        keep &= ~(inside[:, :, None] if time else inside[:, None, :])
    return feats * keep


def weighted_bce(probs, labels, weights, epsilon: float):
    p = torch.clamp(probs.reshape(-1), epsilon, 1.0 - epsilon)
    y = labels.reshape(-1).to(p.dtype)
    return torch.mean(weights.reshape(-1).to(p.dtype) * -(y * torch.log(p) + (1 - y) * torch.log1p(-p)))


def train(family, model_cfg: dict, state: dict, corpus: dict, recipe: dict, gen_seed: int,
          steps: int, device, dtype=torch.float64, half_batch: bool = False,
          feats_in: list | None = None) -> dict:
    """``steps`` steps of the recipe from ``state`` (the model's initial
    state dict): {"losses": [steps], "grads": {leaf: first gradient},
    "change": {leaf: parameters after ``steps`` minus before}, "feats":
    [steps] of its own features}, on the CPU.  ``corpus``: {"kind": "audio"
    | "spectrogram", "providers": [Provider], "step_ms", "scale"}.
    ``feats_in``: the features the program's model consumed in each step,
    merged into the model stage's input (see the module's docstring).
    ``half_batch`` plants a fault: the loss is the mean over the first half
    of the rows alone."""
    gen = torch.Generator(device=device).manual_seed(int(gen_seed))
    params = {k: v.detach().to(device=device, dtype=dtype).clone().requires_grad_(True)
              for k, v in state.items() if not k.endswith((".mean", ".var"))}
    stats = {k: v.to(device=device, dtype=dtype) for k, v in state.items()
             if k.endswith((".mean", ".var"))}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = recipe["optimizer"]
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    batch, frames = recipe["batch_size"], model_cfg["spectrogram_length"]
    out = {"losses": [], "feats": []}
    for step in range(1, steps + 1):
        if corpus["kind"] == "audio":
            pcm, labels, pen = draw_audio(corpus["providers"], gen, batch, frames,
                                          corpus["step_ms"], device)
            feats = RF.features(pcm, corpus["step_ms"], dtype)
        else:
            feats, labels, pen = draw_spectrograms(corpus["providers"], gen, batch, frames,
                                                   corpus["scale"], device, dtype)
        feats = spec_augment(gen, feats, recipe["time_mask_max_size"], recipe["time_mask_count"],
                             recipe["freq_mask_max_size"], recipe["freq_mask_count"])
        out["feats"].append(feats.detach().cpu())
        if feats_in is not None:
            feats = RF.merge(feats, feats_in[step - 1])
        keep = None
        if model_cfg.get("dropout", 0) > 0:
            keep = torch.rand((batch, family.dropout_width(model_cfg)), generator=gen,
                              device=device) < 1.0 - model_cfg["dropout"]
        weights = pen * torch.where(labels > 0.5, recipe["positive_class_weight"],
                                    recipe["negative_class_weight"])
        probs = family.forward({**params, **stats}, model_cfg, feats, train=True, keep=keep)
        rows = slice(0, batch // 2) if half_batch else slice(None)
        loss = weighted_bce(probs[rows], labels[rows], weights[rows], recipe["bce_epsilon"])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        out["losses"].append(float(loss.detach()))
        if step == 1:
            out["grads"] = {k: g.detach().to("cpu", torch.float64) for k, g in grads.items()}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                mu[k] = opt["b1"] * mu[k] + (1 - opt["b1"]) * g
                nu[k] = opt["b2"] * nu[k] + (1 - opt["b2"]) * g * g
                m_hat = mu[k] / (1 - opt["b1"] ** step)
                v_hat = nu[k] / (1 - opt["b2"] ** step)
                p -= recipe["learning_rate"] * m_hat / (torch.sqrt(v_hat) + opt["eps"])
    out["change"] = {k: (p.detach() - start[k]).to("cpu", torch.float64) for k, p in params.items()}
    return out
