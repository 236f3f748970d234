"""What a cell is made of, found by name under a checkout's root:
BENCHMARK.json's entries, the configuration file it names, the traffic mix
portbench/traffic/<traffic>.json, whose "driver" names the code that runs
it (portbench/drivers/<driver>.py), the limits of its correctness check
portbench/limits/<cell>.json, and each per-layer metric's reader
portbench/metrics/<metric>.py. A new cell, configuration, mix or metric is
new files and entries; no file here changes for it."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def sub_seed(seed: int, *keys: int) -> int:
    """A seed below 2**63 for one use, from --seed and the use's keys."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1, np.uint64)[0] >> 1)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    """The module of a file found by name (a metric's name may hold dots),
    loaded once per path."""
    name = "portbench_file_" + hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:16]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@dataclass
class Outcome:
    """What a driver hands back from one run of a cell: the end-to-end
    values by metric name, the data the per-layer readers read, each
    compared number with its limit, the numbers read beside them, and the
    device's readings."""
    e2e: dict[str, float]
    layer: dict
    checks: dict[str, tuple[float, float]]
    readings: dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None

    @property
    def correct(self) -> bool:
        return all(value <= limit for value, limit in self.checks.values())


@dataclass
class Cell:
    root: Path
    manifest: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> list[dict]:
        """The manifest's end-to-end metrics (trace off) or per-layer ones
        (trace on) that this cell reports: those without a "workloads" key
        and those that list it."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]

    def driver(self) -> ModuleType:
        return _module(self.root / "portbench" / "drivers" / f"{self.traffic['driver']}.py")

    def reader(self, metric: str) -> ModuleType:
        return _module(self.root / "portbench" / "metrics" / f"{metric}.py")


def cell(name: str, root: Optional[Path] = None) -> Cell:
    root = Path(root or ROOT)
    manifest = _json(root / "BENCHMARK.json")
    workloads = {w["name"]: w for w in manifest["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"there are {sorted(workloads)}")
    workload = workloads[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    return Cell(root=root, manifest=manifest, workload=workload,
                config=_json(root / configs[workload["config"]]["file"]),
                traffic=_json(root / "portbench" / "traffic" / f"{workload['traffic']}.json"),
                limits=_json(root / "portbench" / "limits" / f"{name}.json"))
