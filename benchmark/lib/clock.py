"""Waiting for the device and timing a call on it."""

from __future__ import annotations

import time

import torch


def sync_fn(dev: torch.device):
    """The wait for ``dev``: ``torch.cuda.synchronize`` on the card."""
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def timer_ms(dev: torch.device, fn) -> float:
    """Milliseconds of ``fn()`` by CUDA events on the card (by the host's
    clock elsewhere, which only the CPU tests use)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)
