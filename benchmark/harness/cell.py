"""A cell of ``BENCHMARK.json`` resolved to its files by name: the
configuration (``configs/<config>.json``), the traffic mix
(``traffic/<traffic>.json``), the family (``families/<family>.py``, named
by the configuration), the window driver (``drivers/<driver>.py``, named by
the mix), the limits of its comparison (``checks/<workload>.json``) and the
reader of each per-layer metric (``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    spec: Dict                 # the cell's entry of ``workloads``
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]     # the end-to-end metrics this cell reports
    per_layer: List[Dict]      # the per-layer metrics this cell reports
    readers: Dict[str, Callable] = field(default_factory=dict)

    @property
    def family(self):
        return importlib.import_module(
            f"benchmark.families.{self.config['family']}")

    @property
    def driver(self):
        return importlib.import_module(
            f"benchmark.drivers.{self.traffic['driver']}")


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reader(path: str) -> Callable:
    name = "benchmark_metric_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, bench_file: str = None, root: str = ROOT) -> Cell:
    """The cell named ``workload`` of ``bench_file`` (the repository's
    ``BENCHMARK.json`` by default), its files under ``root``."""
    bench = _json(bench_file or os.path.join(os.path.dirname(root),
                                             "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    spec = cells[workload]
    config = _json(os.path.join(root, "configs", spec["config"] + ".json"))
    traffic = _json(os.path.join(root, "traffic", spec["traffic"] + ".json"))
    limits = _json(os.path.join(root, "checks", workload + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload) and m["moves"] in reported]
    readers = {m["name"]: _reader(os.path.join(root, "metrics",
                                               m["name"] + ".py"))
               for m in per_layer}
    return Cell(workload, spec, config, traffic, limits["limits"], e2e,
                per_layer, readers)
