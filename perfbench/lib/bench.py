"""BENCHMARK.json and the files it names: a cell's configuration, traffic
mix, kind of traffic and metric readers, each found by its name."""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "perfbench")


def load_module(path: str, name: str):
    """Import the Python file `path` (its name may hold '-' and '.')."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of `workloads` with everything it names."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        here = os.path.join(root, "perfbench")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = _json(os.path.join(root, self.config_entry["file"]))
        cname = self.config["name"]
        self.builder = os.path.join(here, "configs", cname + ".py")
        self.reference = os.path.join(here, "reference", cname + ".py")
        self.traffic = _json(os.path.join(here, "traffic", self.workload["traffic"] + ".json"))
        self.kind = os.path.join(here, "kinds", self.traffic["kind"] + ".py")

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
        self.readers = {m["name"]: os.path.join(here, "metrics", m["name"] + ".py") for m in self.per_layer}


def load(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))
