"""The measuring code beside the port: chip_smoke.py's bound and the
profiler-key parsing of microwakeword_tpu_torch/frontend/ab.py (both run on
the card; these parts need none)."""

import importlib.util
from pathlib import Path

import pytest

from microwakeword_tpu_torch.frontend import ab

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bound_counts_no_more_work_than_the_kernel_does():
    """The least work per hop must not exceed what the kernel does: launch
    A's 11,760 (csrc/frontend.cu's header) and B's 27 per feature cell."""
    smoke = _chip_smoke()
    per_hop = smoke.frontend_flops_per_hop()
    assert per_hop == 11767
    assert per_hop <= 11760 + 27 * 40
    ops_ms, by = smoke.frontend_bound_ms(64, 160000, 998, 2)
    assert by == "operations"
    assert ops_ms == pytest.approx(64 * 998 * 11767 / 67e12 * 1e3)
    assert smoke.frontend_bound_ms(64, 160000, 499, 2)[1] == "bytes"


@pytest.mark.parametrize("key,name", [
    ("void (anonymous namespace)::filterbank_kernel<short, 160>(short const*, int, int, int, "
     "(anonymous namespace)::Tables, float*, float*)", "filterbank_kernel<short, 160>"),
    ("void (anonymous namespace)::carry_scan_kernel(float const*, float const*, float*, int, int)",
     "carry_scan_kernel"),
    ("agc_kernel(float const*, float*, int, int)", "agc_kernel"),
])
def test_profiler_keys_name_the_kernel(key, name):
    assert ab.kernel_name(key) == name
