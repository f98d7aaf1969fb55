"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under the checkout's ``zkbench/`` folder:

* a configuration: the file its ``configs`` entry names (a JSON object;
  its ``adapter`` and ``reference`` keys name a module under
  ``zkbench/adapters/`` and ``zkbench/reference/``);
* a traffic mix: ``zkbench/traffic/<traffic>.json``;
* a per-layer metric: its reader ``zkbench/metrics/<metric>.py`` (a
  function ``read(ctx)`` returning a number, or None when it finds
  nothing to read).

A later cell, configuration or metric is a new file and a new entry; no
existing file changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
"""The checkout root: BENCHMARK.json lies here, beside ``zkbench/``."""


class Manifest:
    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        """The configuration's file, as run."""
        return json.loads((self.root / self._entry("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "zkbench" / "traffic" / f"{name}.json").read_text())

    def _applies(self, metric: dict, cell: str) -> bool:
        return cell in metric.get("workloads", [cell])

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.data["per_layer"] if self._applies(m, cell)]

    def reader(self, metric: str):
        """The ``read`` function of ``zkbench/metrics/<metric>.py``."""
        path = self.root / "zkbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"zkbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def adapter(name: str):
    """The system-under-test adapter ``zkbench.adapters.<name>``."""
    return importlib.import_module(f"zkbench.adapters.{name}")


def reference(name: str):
    """The plain reference ``zkbench.reference.<name>``."""
    return importlib.import_module(f"zkbench.reference.{name}")
