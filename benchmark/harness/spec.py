"""The benchmark's data: BENCHMARK.json, and the files it names by name.

  configs/<configuration>.json   a deployment: genome, signal, app, flags,
                                 the limits of its comparison
  traffic/<mix>.json             read lengths and counts of a pass
  apps/<app>.py                  how a pass calls the app, and its checks
  metrics/<metric>.py            a metric's reader (every metric but
                                 setup_s)

A cell in BENCHMARK.json names only its configuration and its mix.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    app: object                       # the apps/<app>.py module
    end_to_end: List[dict]            # the cell's end-to-end metrics
    per_layer: List[dict]             # the cell's per-layer metrics
    readers: Dict[str, Callable]      # metric name -> read(), setup_s aside


def load_bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json where None)."""
    bench = bench or load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(REPO, cfg["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(ROOT, "traffic", w["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    app = load_module(os.path.join(ROOT, "apps", config["app"]["name"]
                                   + ".py"), "bench_app_" + w["config"])
    # an end-to-end metric without a list is every cell's; a per-layer
    # metric names the cells it is read in
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per = [m for m in bench["per_layer"] if name in m["workloads"]]
    readers = {m["name"]: load_module(
        os.path.join(ROOT, "metrics", m["name"] + ".py"),
        "bench_metric_" + m["name"].replace(".", "_")).read
        for m in e2e + per if m["name"] != "setup_s"}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, app=app, end_to_end=e2e, per_layer=per,
                readers=readers)
