"""Finding a cell's parts by name: BENCHMARK.json, the configuration
file, the traffic file and its generator, the metric readers, the kernel
roofline counts and the correctness limits."""
from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str, root: str):
    """portbench/<kind>/<name>.py loaded by its path, so that a name may
    hold the '.' and '-' that BENCHMARK.json allows."""
    path = os.path.join(root, "portbench", kind, name + ".py")
    key = f"portbench._{kind}.{name.replace('.', '_').replace('-', '_')}"
    mod = sys.modules.get(key)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic,
    metrics and limits resolved. `bench` may be given in place of the
    BENCHMARK.json found at `root`, where the files are read from."""

    def __init__(self, name: str, bench: dict | None = None,
                 root: str = ROOT) -> None:
        self.root = root
        self.bench = (bench if bench is not None
                      else load_json(os.path.join(root, "BENCHMARK.json")))
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = by_name[name]
        self.chips = int(self.workload["chips"])
        cfg_entry = {c["name"]: c for c in self.bench["configs"]}[
            self.workload["config"]]
        self.config = load_json(os.path.join(root, cfg_entry["file"]))
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(os.path.join(
            root, "portbench", "traffic", self.traffic_name + ".json"))
        self.limits = load_json(os.path.join(
            root, "portbench", "limits", name + ".json"))

    def metrics(self, trace: bool) -> list[dict]:
        """The metric entries this cell reports: end_to_end without the
        trace, per_layer with it, each where its `workloads` (if given)
        name this cell."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        """metrics/<metric>.py: read(run) -> a number, or None where the
        run has nothing to read; optionally SPANS {span: (target,
        attribute)} and KERNELS (roofline names) that a traced run
        records for it."""
        return _module("metrics", metric, self.root)

    def roofline(self, kernel: str):
        """rooflines/<kernel>.py: the kernel's operations and bytes from
        a call's shapes."""
        return _module("rooflines", kernel, self.root)

    def generator(self):
        """traffic/<generator>.py of the traffic file: make_source(seed,
        width, height, params) -> an object with make(i)."""
        return _module("traffic", self.traffic["generator"], self.root)
