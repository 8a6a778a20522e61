"""Finding a cell's pieces by the names in ``BENCHMARK.json``.

- a configuration: ``port_bench/configs/<config>.json``
- a traffic mix: ``port_bench/traffic/<traffic>.json``, which names its
  driver
- a driver: ``port_bench/drivers/<driver>.py``, with ``run(ctx)``
- a metric: ``port_bench/metrics/<metric>.py``, with ``read(record)``
- a cell's correctness limits: ``port_bench/limits/<cell>.json``

A later cell, mix, driver or metric is a new file and a new entry; nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Registry:
    """The benchmark under ``root`` (a checkout's root: ``BENCHMARK.json``
    and ``port_bench/``)."""

    def __init__(self, root: Path | str):
        self.root = Path(root)
        self.base = self.root / "port_bench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        path = self.base / kind / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no {kind} file {path}")
        return json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next((c for c in self.bench["configs"] if c["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no config {name!r} in BENCHMARK.json")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def _module(self, kind: str, name: str):
        path = self.base / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} module {path}")
        spec = importlib.util.spec_from_file_location(
            f"port_bench.{kind}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def driver(self, name: str):
        return self._module("drivers", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def metrics_for(self, cell: str, traced: bool) -> list[dict]:
        """The metric entries a run of ``cell`` reports: its end-to-end
        metrics untraced, its per-layer ones traced; an entry with
        ``workloads`` only in the cells it lists."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]
