"""nanopolish_tpu_torch `index` + `eventalign --device cpu` against the
frozen goldens (tests/golden/eventalign.tsv, eventalign_summary.tsv,
eventalign.sam).

The pipeline of tests/test_golden_outputs.py:71-103 is rebuilt with the
port's own writers and synthetic-signal generator, the CLI runs as a
user would run it (``python -m nanopolish_tpu_torch``), and the output
must equal the goldens byte for byte: the port reproduces the JAX scan
path's f32 arithmetic (sum order, fused multiply-adds, the LAPACK solve
sequence), so no tolerance is needed.  ``_differing_rows`` reports how
many rows differ, for the failure message.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.apps import eventalign as ea_app
from nanopolish_tpu_torch.io.bam import BamRecord, BamWriter
from nanopolish_tpu_torch.io.slow5 import Slow5Writer
from nanopolish_tpu_torch.models.pore_model import PoreModelSet
from nanopolish_tpu_torch.models.squiggle import SquiggleScalings
from nanopolish_tpu_torch.utils.alphabet import DNA_ALPHABET
from nanopolish_tpu_torch.utils.synthetic import (random_sequence,
                                                  synthetic_raw_signal)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


def _write_fa(path, name, seq):
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), 60):
            fh.write(seq[i:i + 60] + "\n")


def _adc(pa):
    return np.clip(pa * 8192.0 / 1400.0, -32000, 32000).astype(np.int16)


def _cli(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "nanopolish_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.fixture(scope="module")
def ea_pipe(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_golden_ea")
    rng = np.random.default_rng(1234)
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    genome = random_sequence(rng, 900)
    ref_fa = str(d / "ref.fa")
    _write_fa(ref_fa, "tig1", genome)
    fastq, slow5 = str(d / "reads.fastq"), str(d / "sig.slow5")
    plan = [("gr0", 40, False), ("gr1", 420, True),
            ("gr2", 180, False), ("gr3", 560, True)]
    L = 300
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for name, pos, is_rev in plan:
            seg = genome[pos:pos + L]
            basecall = DNA_ALPHABET.reverse_complement(seg) if is_rev else seg
            fq.write(f"@{name}\n{basecall}\n+\n{'I' * L}\n")
            sc = SquiggleScalings.from4(1.5, 1.01, 0.0, 1.0)
            pa = synthetic_raw_signal(rng, basecall, model, sc,
                                      samples_per_base=10.0, leader=400,
                                      trailer=100)
            sw.write(name, _adc(pa), 8192.0, 0.0, 1400.0, 4000.0)
    r = _cli("index", fastq, "--slow5", slow5)
    assert r.returncode == 0, r.stderr
    bam = str(d / "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"], [len(genome)])
    for name, pos, is_rev in plan:
        seg = genome[pos:pos + L]
        w.write(BamRecord(qname=name, flag=16 if is_rev else 0, tid=0,
                          pos=pos, mapq=60, cigar=[(0, L)], seq=seg,
                          qual=np.full(L, 30, np.uint8)))
    w.close()
    return dict(dir=d, ref_fa=ref_fa, fastq=fastq, bam=bam)


def _differing_rows(got: str, want: str) -> int:
    gl, wl = got.splitlines(), want.splitlines()
    return abs(len(gl) - len(wl)) + sum(a != b for a, b in zip(gl, wl))


def _check(name, got):
    want = open(os.path.join(GOLDEN_DIR, name)).read()
    n = _differing_rows(got, want)
    print(f"{name}: {n} rows differ from the golden")
    assert n == 0 and got == want


def test_eventalign_cli_cpu_matches_golden_tsv_and_summary(ea_pipe):
    p = ea_pipe
    summary = str(p["dir"] / "summary.tsv")
    r = _cli("eventalign", "-r", p["fastq"], "-b", p["bam"], "-g",
             p["ref_fa"], "--print-read-names", "--summary", summary,
             "--device", "cpu")
    assert r.returncode == 0, r.stderr
    _check("eventalign.tsv", r.stdout)
    _check("eventalign_summary.tsv", open(summary).read())


def test_eventalign_cpu_matches_golden_sam(ea_pipe):
    p = ea_pipe
    out = io.StringIO()
    ea_app.main(["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"], "--sam",
                 "--device", "cpu"], stdout=out)
    _check("eventalign.sam", out.getvalue())


@pytest.mark.parametrize("opts", [
    "--scale-events", "--signal-index --samples", "-w tig1:100-400",
    "--sam -w tig1:200-500 --max-reads 3"])
def test_eventalign_options_match_jax_package(ea_pipe, opts):
    """Options the goldens do not cover, against the JAX package's own
    eventalign (scan path on the CPU) on the same files."""
    from nanopolish_tpu.apps import eventalign as jax_app
    p = ea_pipe
    base = ["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"]] + opts.split()
    want, got = io.StringIO(), io.StringIO()
    jax_app.main(base, stdout=want)
    ea_app.main(base + ["--device", "cpu"], stdout=got)
    n = _differing_rows(got.getvalue(), want.getvalue())
    print(f"eventalign {opts}: {n} rows differ from the JAX package")
    assert n == 0 and len(got.getvalue()) > 200


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (eventalign through the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_eventalign_gpu_matches_golden_sam(ea_pipe, cuda_device):
    p = ea_pipe
    out = io.StringIO()
    ea_app.main(["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"], "--sam",
                 "--device", "cuda"], stdout=out)
    _check("eventalign.sam", out.getvalue())
