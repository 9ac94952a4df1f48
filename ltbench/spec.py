"""``BENCHMARK.json`` and the files it names, found by name.

A cell names its configuration (``ltbench/configs/<config>.json``) and its
traffic mix (``ltbench/workloads/<traffic>.json``); each metric is read by
``ltbench/metrics/<metric>.py``. A configuration names its model family
(its ``family`` key), whose hooks ``ltbench/families/<family>.py`` holds:
weights, loading, serving, the window's traffic loop, the reference check and
the work counts. A new cell, configuration, mix, metric or family is a new
file and a new entry, never an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Callable, Dict, List


class Spec:
    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, "ltbench")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.dir, "workloads", f"{name}.json")) as f:
            return json.load(f)

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (``trace`` false) or its per-layer
        metrics (``trace`` true): those that list the cell, or list none."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def _module(self, kind: str, name: str):
        path = os.path.join(self.dir, kind, f"{name}.py")
        mod_spec = importlib.util.spec_from_file_location(f"ltbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        sys.modules[mod_spec.name] = mod   # dataclasses look their module up there
        mod_spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str) -> Callable:
        return self._module("metrics", metric).read

    def family(self, name: str):
        """The module of a model family's hooks (``ltbench/families/musetalk.py``
        says what each does)."""
        return self._module("families", name)


def read_metrics(spec: Spec, cell: str, trace: bool, run) -> Dict[str, dict]:
    """Every metric of the cell that its reader finds, with its unit."""
    out = {}
    for m in spec.metrics(cell, trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
