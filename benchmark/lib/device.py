"""The card a run uses, its numerics flags and the caches kept in the checkout."""

from __future__ import annotations

import os
import subprocess

from benchmark.lib.cell import ROOT

# Fixed cache directories inside the checkout (benchmark/.gitignore lists
# them), so that only the first run of a checkout builds or compiles.  The
# port builds its frontend library into microwakeword_tpu_torch/_build/
# inside the checkout by itself.
CACHE = ROOT / "benchmark" / "cache"


def point_caches() -> None:
    """Sends PyTorch's and Triton's kernel caches into the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    # a library that would load JAX by itself is kept from doing so
    os.environ["USE_FLAX"] = "0"


class NoCard(RuntimeError):
    """The run asks for more cards than the machine has."""


def require_cards(count: int):
    """The first CUDA device; raises NoCard unless ``count`` cards are there."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < count:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {count}")
    return torch.device("cuda", 0)


def set_numerics(config: dict) -> None:
    """The precision the configuration states: float32 with TF32 off unless
    it says ``"tf32": true``."""
    import torch

    tf32 = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them, or ''."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""


def device_info(dev, count: int) -> dict:
    """The result's ``device`` object (peak memory filled in by the caller)."""
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
