"""BENCHMARK.json keeps to the benchmark's contract: names, units and
keys from the allowed characters, every named file present, every metric
read by a file of its own, and the bounds within their limits."""

import json
import os
import re

from conftest import BENCH

REPO = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert len(b["command"]) <= 32
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 65536


def test_names_units_and_keys():
    b = _bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["config"] for w in b["workloads"]]
    names += [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for text in [c["why"] for c in b["configs"]] + \
            [m["layer"] for m in b["per_layer"]] + \
            [c["source"] for c in b["configs"]] + b["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_name_has_its_file():
    b = _bench()
    cells = {w["name"]: w for w in b["workloads"]}
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells
    assert "setup_s" in e2e


def test_each_cell_reports_setup_a_rate_and_a_layer():
    from harness import spec
    for w in _bench()["workloads"]:
        cell = spec.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer and set(cell.readers) == \
            {m["name"] for m in cell.per_layer} | names - {"setup_s"}
