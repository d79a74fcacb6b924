"""One cell of the benchmark: its entry in ``BENCHMARK.json``, its workload
file, its configuration file and the metrics it reports.

Everything here is data.  A cell is found by its name in ``BENCHMARK.json``
under a checkout root; its workload file is ``benchmark/workloads/<name>.json``
and its configuration file is the ``file`` that ``BENCHMARK.json`` gives the
configuration.  The workload names its traffic kind, which is the module
``benchmark/traffic/<kind>.py``; the configuration names its family, which
is the module ``benchmark/reference/<family>.py`` and the counter
``benchmark/counts/<family>.py``.  A per-layer metric ``<family>.<suffix>``
is read by ``benchmark/metrics/<family>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """What a run of one cell needs to know, all of it read from files."""

    name: str
    workload: dict  # the workload file
    config: dict  # the configuration file
    entry: dict  # the cell's entry in BENCHMARK.json
    end_to_end: list  # BENCHMARK.json's end-to-end metrics that this cell reports
    per_layer: list  # its per-layer metrics that this cell reports
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False

    @property
    def traffic(self) -> str:
        return self.workload["traffic"]

    @property
    def family(self) -> str:
        return self.config["family"]

    def sub_seed(self, purpose: int) -> int:
        """A seed for one use of the run's seed (inputs, weights, the
        program's generator, the sample of answers checked), below 2**63."""
        return (self.seed * 1_000_003 + 7_919 * purpose) % (2**63 - 1)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, **run) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files; ``run``
    sets seed, seconds and trace."""
    root = Path(root)
    spec = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    workload = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    if workload["traffic"] != entry["traffic"]:
        raise ValueError(f"{name}: BENCHMARK.json says traffic {entry['traffic']!r}, "
                         f"the workload file {workload['traffic']!r}")
    config = load_json(root / configs[entry["config"]]["file"])
    return Cell(
        name=name, workload=workload, config=config, entry=entry,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
        **run,
    )


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` (kind: traffic, reference, counts,
    metrics), imported by name; hyphens in a name map to underscores."""
    return importlib.import_module(f"benchmark.{kind}.{name.replace('-', '_')}")


def metric_family(name: str) -> str:
    """A per-layer metric's reader: the part of its name before the first dot."""
    return name.split(".", 1)[0]
