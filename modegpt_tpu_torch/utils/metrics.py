"""JSON metrics registry.

Same shape as the reference's registry (reference:
src/adapters/model_adapter.py:85-94,137-182): an append-only
``metrics.json`` keyed by timestamped run name, plus one JSON per run
under ``jsons/``.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict

__all__ = ["MetricsRegistry"]


class MetricsRegistry:
    def __init__(self, metrics_dir: str = "./metrics"):
        self.metrics_dir = metrics_dir
        self.path = os.path.join(metrics_dir, "metrics.json")
        self.jsons_dir = os.path.join(metrics_dir, "jsons")
        self._all: Dict = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                try:
                    self._all = json.load(f)
                except json.JSONDecodeError:
                    self._all = {}
        run_name = datetime.now().strftime("%Y_%m_%d--%H_%M_%S")
        self.run: Dict = {
            "RunName": run_name,
            "RunDate": datetime.now().strftime("%b %d, %Y %I:%M %p"),
        }
        self._all[run_name] = self.run

    def __setitem__(self, key: str, value) -> None:
        self.run[key] = value

    def __getitem__(self, key: str):
        return self.run[key]

    def get(self, key: str, default=None):
        return self.run.get(key, default)

    def update(self, other: Dict) -> None:
        self.run.update(other)

    def save(self) -> None:
        os.makedirs(self.metrics_dir, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self._all, f, indent=4, default=str)
        os.makedirs(self.jsons_dir, exist_ok=True)
        note = str(self.run.get("note", "") or "")[:15]
        name = f"{self.run['RunName']}--{note}.json" if note and note != "NA" else f"{self.run['RunName']}.json"
        with open(os.path.join(self.jsons_dir, name), "w") as f:
            json.dump(self.run, f, indent=4, default=str)
