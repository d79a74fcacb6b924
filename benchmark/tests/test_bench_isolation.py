"""The check that no JAX module is loaded compares top-level names whole."""

from __future__ import annotations

import subprocess
import sys

from benchmark.lib.cell import ROOT
from benchmark.lib.isolation import forbidden_modules


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["microwakeword_tpu_torchx", "microwakeword_tpu_torch.models",
                              "jaxtyping", "torch", "flaxen"]) == []
    assert forbidden_modules(["microwakeword_tpu.x", "torch"]) == ["microwakeword_tpu.x"]
    assert forbidden_modules(["jax", "jaxlib.xla_client", "optax", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "optax"]


def test_harness_and_port_load_no_jax():
    """Importing the harness, every traffic kind, reference and reader, and
    the port's modules that the traffic calls, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run\n"
        "from benchmark.lib.cell import module, load_cell, metric_family\n"
        "import json\n"
        "spec = json.load(open(%r))\n"
        "for w in spec['workloads']:\n"
        "    c = load_cell(w['name']); module('traffic', c.traffic); module('reference', c.family)\n"
        "for m in spec['per_layer']: module('metrics', metric_family(m['name']))\n"
        "import microwakeword_tpu_torch.train.loop, microwakeword_tpu_torch.data.sampler\n"
        "import microwakeword_tpu_torch.inference, microwakeword_tpu_torch.evaluate.streaming_eval\n"
        "from benchmark.lib.isolation import forbidden_modules\n"
        "print(forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
