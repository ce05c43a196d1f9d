"""What BENCHMARK.json names, found by name: a cell (`workloads`), its
configuration (the `file` of its `configs` entry), its traffic mix
(`portbench/traffic/<name>.json`) and the per-layer metrics it reports
(`portbench/metrics/<name>.py`, each with UNIT and read(trace_data); a
metric `<name>.<part>` split by the end-to-end metric it moves reads by
`<name>.py`).
A later cell, mix or metric is a new entry and new files; nothing here
lists them.
"""

from __future__ import annotations

import importlib.util
import json
import os


class UnknownName(LookupError):
    pass


class Benchmark:
    def __init__(self, root: str, spec: dict | None = None):
        self.root = root
        if spec is None:
            with open(os.path.join(root, "BENCHMARK.json")) as fh:
                spec = json.load(fh)
        self.spec = spec

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise UnknownName(f"{key}: no entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root, self._entry("configs", name)["file"])) as fh:
            return json.load(fh)

    def traffic(self, name: str) -> dict:
        path = os.path.join(self.root, "portbench", "traffic", f"{name}.json")
        if not os.path.exists(path):
            raise UnknownName(f"traffic: no file {path}")
        with open(path) as fh:
            return json.load(fh)

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell])]

    @staticmethod
    def base_name(name: str, known) -> str:
        """What a metric measures: `name` itself if `known` holds it, else
        the longest of its leading dotted parts that `known` holds. A
        quantity split by the end-to-end metric it moves (`<name>.<part>`,
        each part with a bound or cells of its own) is read as `<name>`."""
        parts = name.split(".")
        for i in range(len(parts), 0, -1):
            if ".".join(parts[:i]) in known:
                return ".".join(parts[:i])
        raise UnknownName(f"metric: nothing measures {name!r}")

    def reader(self, name: str):
        """The module of one per-layer metric (its UNIT and read):
        `portbench/metrics/<base>.py` for base_name(name)."""
        folder = os.path.join(self.root, "portbench", "metrics")
        files = {f[:-3] for f in os.listdir(folder) if f.endswith(".py")}
        name = self.base_name(name, files)
        path = os.path.join(folder, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
