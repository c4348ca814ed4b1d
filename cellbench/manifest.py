"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's file is
the ``file`` of its entry, the mix is ``traffic/<mix>.json`` and each
per-layer metric is read by ``metrics/<metric>.py``. A later cell, mix or
metric is a new file and a new entry: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Manifest:
    """The benchmark's manifest, read from ``root`` (the checkout)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.pkg = self.root / "cellbench"
        with open(self.root / "BENCHMARK.json") as fh:
            self.data = json.load(fh)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's file, with the entry's ``name`` added."""
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as fh:
                    return dict(json.load(fh), name=name)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.pkg / "traffic" / f"{name}.json") as fh:
            return dict(json.load(fh), name=name)

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose ``moves`` the cell reports."""
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", []) or ("workloads" not in m and m["moves"] in moves)]

    def reader(self, metric: str) -> ModuleType:
        return load_reader(self.pkg / "metrics" / f"{metric}.py")


def load_reader(path: Path) -> ModuleType:
    """A metric's reader module, loaded from its file (a metric's name may
    hold dots, so it is no importable module name)."""
    spec = importlib.util.spec_from_file_location(f"cellbench_metric_{path.stem.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load the metric reader {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
