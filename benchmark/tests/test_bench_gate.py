"""The gate that times each train step on the card (``benchmark/lib/gate.py``):
off the card it times a unit on the host's clock; on the card a unit's time
leaves out the host's pauses while it is enqueued, and a unit that waits for
the card ends the run with a message, where it would hang.  Run the card's
cases with

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests/test_bench_gate.py
"""

from __future__ import annotations

import subprocess
import sys
import time

import pytest
import torch

from benchmark.lib import gate as G
from benchmark.lib.cell import ROOT


def test_host_clock_off_the_card():
    gate = G.Gate(torch.device("cpu"))
    for pause in (0.02, 0.04):
        with gate.unit():
            time.sleep(pause)
    gate.close()
    ms = gate.unit_ms()
    assert len(ms) == 2 and 15.0 <= ms[0] < ms[1]


@pytest.mark.cuda
def test_unit_leaves_out_the_hosts_pauses(cuda):
    def body(x, pause):
        for _ in range(4):
            x = torch.tanh(x @ x) * 0.5
            time.sleep(pause)  # the host stalls between launches
        return x

    x = torch.randn(1024, 1024, device=cuda)
    body(x, 0.0)  # first calls and allocations wait for the card: never inside a held unit
    torch.cuda.synchronize()
    gate = G.Gate(cuda)
    for _ in range(3):
        with gate.unit():
            x = body(x, 0.05)
    gate.close()
    torch.cuda.synchronize()
    ms = gate.unit_ms()
    assert len(ms) == 3 and all(0.0 < t < 20.0 for t in ms), ms
    assert torch.isfinite(x).all()


@pytest.mark.cuda
def test_a_unit_that_waits_for_the_card_ends_the_run(cuda):
    code = ("import torch\n"
            "from benchmark.lib import gate as G\n"
            "G.STUCK_S = 1.0\n"
            "g = G.Gate(torch.device('cuda'))\n"
            "with g.unit():\n"
            "    torch.ones(1, device='cuda').sum().item()  # waits for the held stream\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == G.EXIT_STUCK and "held at the gate" in out.stderr, out.stderr
