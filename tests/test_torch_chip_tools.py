"""The measuring code beside the port: the frontend kernel's bound, which
chip_smoke.py takes from the benchmark's counts, and the profiler-key parsing
of microwakeword_tpu_torch/frontend/ab.py (both run on the card; these parts
need none)."""

import pytest

from benchmark.counts import frontend as frontend_counts
from microwakeword_tpu_torch.frontend import ab


def test_bound_counts_no_more_work_than_the_kernel_does():
    """The least work per hop (benchmark/counts/frontend.py, which
    chip_smoke.py's bounds use) must not exceed what the kernel does: launch
    A's 11,760 (csrc/frontend.cu's header) and B's 27 per feature cell."""
    per_hop = frontend_counts.flops_per_hop()
    assert per_hop == 11767
    assert per_hop <= 11760 + 27 * 40
    ops_s, by = frontend_counts.bound_s(64, 160000, 10)
    assert by == "operations"
    assert ops_s == pytest.approx(64 * 998 * 11767 / 67e12)
    assert frontend_counts.bound_s(64, 160000, 20)[1] == "bytes"


@pytest.mark.parametrize("key,name", [
    ("void (anonymous namespace)::filterbank_kernel<short, 160>(short const*, int, int, int, "
     "(anonymous namespace)::Tables, float*, float*)", "filterbank_kernel<short, 160>"),
    ("void (anonymous namespace)::carry_scan_kernel(float const*, float const*, float*, int, int)",
     "carry_scan_kernel"),
    ("agc_kernel(float const*, float*, int, int)", "agc_kernel"),
])
def test_profiler_keys_name_the_kernel(key, name):
    assert ab.kernel_name(key) == name
