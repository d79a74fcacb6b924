"""The port stands alone: it imports no jax/flax/optax and nothing of
microwakeword_tpu, and its entry points run on the CUDA card unless the
caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from microwakeword_tpu_torch.frontend import plain
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import build_model, presets

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "microwakeword_tpu")

_PROBE = """
import json, sys
before = set(sys.modules)
import numpy as np
import torch
torch.set_num_threads(2)
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import build_model, presets
bundle = build_model("mixednet", presets.flagship_config())
model = bundle.init(torch.Generator().manual_seed(0), device="cpu")
state = {k: v.numpy() for k, v in model.state_dict().items()}
audio = np.random.default_rng(0).integers(-8000, 8000, 8000).astype(np.int16)
probs = Model.from_torch(bundle, state, device="cpu").predict_clip(audio)
assert probs.shape == (48 // 3,), probs.shape
added = set(sys.modules) - before
print(json.dumps(sorted(added)))
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_and_predict_load_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert "microwakeword_tpu_torch" in added
    assert [m for m in added if _forbidden(m)] == []


def _sources():
    yield from sorted((REPO / "microwakeword_tpu_torch").rglob("*.py"))
    yield REPO / "chip_smoke.py"


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = build_model("mixednet", presets.flagship_config())
    model = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        Model.from_torch(bundle, state)
    with pytest.raises(RuntimeError, match="CUDA"):
        bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        bundle.load(state)
    with pytest.raises(RuntimeError, match="CUDA"):
        plain.streaming_state_init((2,))
    assert Model.from_torch(bundle, state, device="cpu").predict_spectrogram(
        np.zeros((9, 40), np.float32)
    ).shape == (3,)
