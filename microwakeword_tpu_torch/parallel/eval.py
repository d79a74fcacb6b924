"""Streamed evaluation of many tracks over a mesh (port of parallel/eval.py).

Tracks are grouped into step-count buckets (multiples of 512 steps), zero
padded to the bucket's length and stacked, the stack padded with zero tracks
to a multiple of the mesh's size; each rank scans its contiguous block of
the stack with the ring-buffer ``stream_scan`` and one all-gather collects
the blocks in rank order.  Tracks are independent and streaming is causal,
so the padding changes no kept step.
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def batched_track_probs(bundle, model, tracks, mesh,
                        bucket_granularity: int = 512) -> list[torch.Tensor]:
    """Streaming per-step probabilities [T_i // stride] on the model's device
    for a list of [T_i, F] tracks, in input order with the padding trimmed
    (every rank returns all of them)."""
    size = mesh.size
    device = next(model.parameters()).device
    stride = bundle.stride
    steps = [t.shape[0] // stride for t in tracks]
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(steps):
        if s <= 0:
            continue
        b = max(bucket_granularity, -(-s // bucket_granularity) * bucket_granularity)
        buckets.setdefault(b, []).append(i)

    out = [torch.zeros((0,), device=device) for _ in tracks]
    for bucket_steps, idxs in buckets.items():
        n_pad = -(-len(idxs) // size) * size
        x = np.zeros((n_pad, bucket_steps * stride, bundle.input_features), np.float32)
        for row, i in enumerate(idxs):
            x[row, : steps[i] * stride] = tracks[i][: steps[i] * stride]
        x = torch.from_numpy(x[mesh.rows(n_pad)]).to(device)
        probs = mesh.gather_rows(bundle.stream_scan(model, x))
        for row, i in enumerate(idxs):  # probs [n_pad, bucket_steps, 1]
            out[i] = probs[row, : steps[i]].reshape(-1)
    return out
