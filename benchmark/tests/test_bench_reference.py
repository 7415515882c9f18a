"""The comparison that decides ``correct``, on the CPU: the plain
reference against the port's ``--device cpu`` route on a two-read corpus
(a whole run's set-up, window and check, without the look for a card),
the bfloat16 control coming out not correct, and a run with the timed
path broken underneath coming out not correct: an answer altered where
it is produced, and half of the reads left out."""

import time

import pytest
import torch

import calibrate
import run
from conftest import tiny_cell
from harness import check

APPS = ["ea-longread", "cm-longread"]
SEED = 2 ** 31 + 11


def _run(workload, workdir, reads=2):
    cell = tiny_cell(workload, reads)
    return run.run_cell(cell, SEED, 0.01, False, "cpu", time.perf_counter(),
                        workdir)


@pytest.mark.parametrize("workload", APPS)
def test_reference_agrees_with_the_port(workload, workdir):
    out = _run(workload, workdir)
    n = out["numbers"]
    rows, value, text = tiny_cell(workload).app.NAMES
    assert out["correct"], n
    assert n[rows] == 0 and n[text] == 0 and n["passes_differing"] == 0
    assert n[value] <= 0.005 + 1e-6          # the printed value's rounding
    assert out["attempted"] == 2 and out["failed"] == 0


@pytest.mark.parametrize("workload", APPS)
def test_control_is_not_correct(workload, workdir):
    cell = tiny_cell(workload)
    r = calibrate.readings(cell, SEED, "cpu", True, workdir)
    assert check.judge(r["program"], cell.config["limits"])
    assert not check.judge(r["control"], cell.config["limits"]), r


def test_the_reference_chain_is_its_own(workdir):
    """eventalign's reference rows are the same with no guesses of the
    hand-offs, with the program's, and with every guess wrong."""
    cell = tiny_cell("ea-longread")
    ds, names, new_sink, one_pass = run.prepare(cell, SEED, "cpu", workdir)
    sink = one_pass(new_sink())
    prog = {n: sink.lines(n) for n in names}

    def shifted(line):
        f = line.split("\t")
        f[5] = str(int(f[5]) + 1)
        return "\t".join(f)
    wrong = {n: [shifted(ln) for ln in lines] for n, lines in prog.items()}
    reads = [r for r in ds.reads if r.name in set(names)]
    alone, guessed, misled = (check.reference_rows(cell, ds, reads, "cpu", g)
                              for g in ({}, prog, wrong))
    assert alone == guessed == misled
    assert all(len(v) > 100 for v in alone.values())


def _alter_eventalign(monkeypatch):
    from nanopolish_tpu_torch.alignment import eventalign as ea
    real = ea.viterbi_segments

    def altered(segs, *a, **k):
        # one match state of every segment's path read as a bad event
        res = real(segs, *a, **k)
        for j, (evs, kms, st) in enumerate(res):
            i = st.find("M", len(st) // 4)
            if i >= 0:
                res[j] = (evs, kms, st[:i] + "B" + st[i + 1:])
        return res
    monkeypatch.setattr(ea, "viterbi_segments", altered)


def _alter_methylation(monkeypatch):
    from nanopolish_tpu_torch.apps import call_methylation as cm
    real = cm.forward_arrays_async

    def altered(*a, **k):
        fetch = real(*a, **k)

        def f():
            s = fetch().copy()
            s[0] += 0.5
            return s
        return f
    monkeypatch.setattr(cm, "forward_arrays_async", altered)


@pytest.mark.parametrize("workload,alter", [
    ("ea-longread", _alter_eventalign), ("cm-longread", _alter_methylation)])
def test_an_altered_answer_is_not_correct(workload, alter, workdir,
                                          monkeypatch):
    alter(monkeypatch)
    out = _run(workload, workdir)
    assert not out["correct"], out["numbers"]


@pytest.mark.parametrize("workload", APPS)
def test_half_the_reads_left_out_is_not_correct(workload, workdir,
                                                monkeypatch):
    from nanopolish_tpu_torch.apps.bam_processor import BamBatchProcessor
    real = BamBatchProcessor.batches

    def half(self):
        for b in real(self):
            yield b[::2]
    monkeypatch.setattr(BamBatchProcessor, "batches", half)
    out = _run(workload, workdir)
    assert not out["correct"], out["numbers"]
    assert out["failed"] == 1


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "cm-longread", "--seed", "1",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys
    from conftest import BENCH
    p = subprocess.run([sys.executable, f"{BENCH}/run.py", "--workload",
                        "cm-longread", "--seed", "5", "--seconds", "1"],
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
