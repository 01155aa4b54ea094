"""``BENCHMARK.json`` and the files it names: configurations, traffic
mixes, cells' limits, metric readers and the per-family modules, all
found by name under ``benchmark/``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``, imported by path (names may hold
    ``-`` and ``.``) once per process."""
    key = f"bench_{kind}_{name}"
    if key not in sys.modules:
        path = BENCH / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def load_metric(name: str):
    """The reader of the per-layer or end-to-end metric ``name``:
    ``benchmark/metrics/<name>.py``, or where there is none, the reader of
    its family, the name up to its first dot (``mfu`` reads ``mfu.train``
    and ``mfu.serve``, taking the mode from the cell)."""
    if (BENCH / "metrics" / f"{name}.py").exists():
        return load_module("metrics", name)
    return load_module("metrics", name.split(".")[0])


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, spec: dict = None) -> Cell:
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name=name, chips=w["chips"],
                config=load_json(ROOT / config["file"]),
                traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH / "cells" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=per_layer)
