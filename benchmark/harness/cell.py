"""Finding a cell's files by name: the manifest (BENCHMARK.json), the cell
file under workloads/, its traffic mix under workloads/traffic/, its
configuration and plain reference under configs/, its system under
systems/ and each metric's reader under metrics/.  A later cell or metric
adds files; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ck_k(cfg: dict, side: str) -> int:
    """log2 of a side's key size: the side's own `ck_k`, else the
    configuration's."""
    return cfg[side].get("ck_k", cfg["ck_k"])


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest, with its files read."""

    def __init__(self, manifest: dict, name: str, data_dirs: Optional[List[str]] = None):
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in the manifest")
        self.entry = entries[name]
        self.name = name
        self.dirs = list(data_dirs or []) + [BENCH]
        cell = read_json(self.find("workloads", f"{name}.json"))
        if (cell["config"], cell["traffic"]) != (self.entry["config"], self.entry["traffic"]):
            raise ValueError(f"{name}: the cell file and the manifest disagree")
        self.config = read_json(self.find("configs", f"{self.entry['config']}.json"))
        self.traffic = read_json(
            self.find("workloads", "traffic", f"{self.entry['traffic']}.json"))
        self.manifest = manifest

    def find(self, *parts: str) -> str:
        for d in self.dirs:
            path = os.path.join(d, *parts)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(os.path.join(*parts))

    def metrics(self, kind: str) -> List[dict]:
        """The manifest's `end_to_end` or `per_layer` metrics this cell reports."""
        return [m for m in self.manifest[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        return load_module(self.find("metrics", f"{metric}.py"), f"bench_metric_{metric}")

    def system(self):
        return load_module(self.find("systems", f"{self.config['system']}.py"),
                           f"bench_system_{self.config['system']}")

    def reference(self):
        """configs/<name>.ref.py, or the one the configuration names."""
        name = self.config.get("reference", self.config["name"])
        return load_module(self.find("configs", f"{name}.ref.py"), f"bench_ref_{name}")
