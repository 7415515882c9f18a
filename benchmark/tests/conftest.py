"""Shared set-up of the benchmark's CPU tests: the benchmark's folder and
the repo root on sys.path, torch on two threads, and ``tiny_cell``: a
cell cut to two reads of about 800 bases, which the port's CPU route and
the plain reference run in seconds."""

import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)


# eventalign's cell is out of BENCHMARK.json while its rate cannot be
# bounded on the card's host (PERF.md, Open questions); its configuration,
# app adapter and reference stay, and the tests still hold them
EA_CELL = {
    "configs": [{"name": "r94-ecoli-eventalign",
                 "file": "benchmark/configs/r94-ecoli-eventalign.json"}],
    "workloads": [{"name": "ea-longread", "config": "r94-ecoli-eventalign",
                   "traffic": "longread", "chips": 1}],
}


def bench_with_eventalign() -> dict:
    from harness import spec
    bench = spec.load_bench()
    for k, entries in EA_CELL.items():
        bench[k] = bench[k] + entries
    return bench


def tiny_cell(workload: str, reads: int = 2):
    from harness import spec
    cell = spec.load_cell(workload, bench_with_eventalign())
    cell.config["genome"]["length"] = 20000
    cell.traffic.update(median_bases=900, sigma=0.2, min_bases=700,
                        max_bases=1200, check_reads=reads)
    # coverage of `reads` reads of the mix's mean length
    cell.config["coverage"] = reads * 900 * math.exp(0.02) / 20000
    return cell


@pytest.fixture
def workdir(tmp_path):
    return str(tmp_path)
