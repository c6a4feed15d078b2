"""What `run.py` builds a run from: `BENCHMARK.json`, and the files its
names point to.

A cell (a ``workloads`` entry) names a configuration (``configs`` entry,
whose ``file`` holds the model's sizes), a traffic mix
(``traffic/<name>.json``, whose ``kind`` names its driver,
``drivers/<kind>.py``) and, through the metric lists, its metrics: the
end-to-end ones its traffic kind measures itself, and one reader a per-layer
metric (``metrics/<name>.py``, whose ``read(record)`` returns the value
or None). The limits of a cell's correctness comparison are in
``limits/<cell>.json``. Nothing here lists cells, mixes or metrics: a new
one is new files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "modegpt_tpu")


class Cell:
    """One cell of a benchmark file, with everything it names loaded."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        entries = [w for w in self.bench["workloads"] if w["name"] == name]
        if len(entries) != 1:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.entry = entries[0]
        self.name = name
        configs = [c for c in self.bench["configs"] if c["name"] == self.entry["config"]]
        if len(configs) != 1:
            raise SystemExit(f"workload {name!r} names config {self.entry['config']!r}, which is not listed")
        self.config_entry = configs[0]
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        self.traffic = load_traffic(root, self.entry["traffic"])
        self.limits = load_json(os.path.join(root, "perfbench", "limits", f"{name}.json"))
        self.chips = int(self.entry["chips"])

    def metrics(self, section: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[section] if m.get("workloads") is None or self.name in m["workloads"]]

    def driver(self):
        return importlib.import_module(f"perfbench.drivers.{self.traffic['kind']}")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_traffic(root: str, name: str) -> Dict:
    """A traffic mix's parameters, ``traffic/<name>.json``."""
    path = os.path.join(root, "perfbench", "traffic", name + ".json")
    if not os.path.exists(path):
        raise SystemExit(f"traffic mix {name!r} not found: {path}")
    return load_json(path)


def load_metric(name: str, root: str = ROOT):
    """The reader module of per-layer metric ``name``
    (``metrics/<name>.py``; a name may hold dots, so it is loaded by
    path)."""
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``modegpt_tpu_torch`` is not ``modegpt_tpu``)."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def read_per_layer(cell: Cell, record: Dict) -> Dict[str, Dict]:
    """Each of the cell's per-layer metrics that its reader finds
    something to read for; the others are left out."""
    out = {}
    for m in cell.metrics("per_layer"):
        value = load_metric(m["name"], cell.root).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def passes(check: Dict) -> bool:
    """A compared number within its limit (a NaN or a missing number is
    not)."""
    v = check["value"]
    return isinstance(v, (int, float)) and not math.isnan(v) and v <= check["limit"]


def correct(checks: Dict[str, Dict]) -> bool:
    return bool(checks) and all(passes(c) for c in checks.values())
