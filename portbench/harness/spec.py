"""What a run measures, found by name.

BENCHMARK.json names the cell; everything that belongs to one piece
sits in files of its own under portbench/, found by its name:

  * a cell:          cells/<cell>.json (its sizes and its check)
  * a configuration: configs/<config>.json, whose `generator` names its
                     document generator, traffic/<generator>.py
  * a traffic mix:   traffic/<traffic>.json, whose `entry` names the
                     module the window drives, entries/<entry>.py
  * a per-layer metric: metrics/<name>.py, its reader

so a later change adds a cell, a configuration or a metric by adding
files and BENCHMARK.json entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

PKG = Path(__file__).resolve().parent.parent


@dataclass
class Metric:
    """What a run reports of a metric: its name, read by the reader of
    that name, and its unit."""

    name: str
    unit: str


@dataclass
class Spec:
    root: Path
    cell_name: str
    chips: int
    config: dict
    traffic: dict
    cell: dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)
    pkg: Path = PKG

    def generator(self):
        return module(self.pkg, "traffic", self.config["generator"])

    def entry(self):
        return module(self.pkg, "entries", self.traffic["entry"])

    def reader(self, name: str):
        """The `read(run)` function of metrics/<name>.py."""
        return module(self.pkg, "metrics", name).read

    def rules_dir(self) -> Path:
        return self.pkg / self.config["rules"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric(entry: dict) -> Metric:
    return Metric(entry["name"], entry["unit"])


def load(root: Path, cell_name: str, pkg: Path = PKG) -> Spec:
    """The spec of one cell of `root`/BENCHMARK.json. Raises KeyError for
    a cell that BENCHMARK.json does not list."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {cell_name!r}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    return Spec(
        root=root,
        cell_name=cell_name,
        chips=int(w["chips"]),
        config=config,
        traffic=_json(pkg / "traffic" / f"{w['traffic']}.json"),
        cell=_json(pkg / "cells" / f"{cell_name}.json"),
        end_to_end=[_metric(m) for m in bench["end_to_end"]],
        per_layer=[_metric(m) for m in bench["per_layer"]],
        pkg=pkg,
    )


def module(pkg: Path, kind: str, name: str):
    """The module in file <pkg>/<kind>/<name>.py, loaded once."""
    key = f"portbench_{kind}_{name}_{pkg}".replace(".", "_").replace("/", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, pkg / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]
