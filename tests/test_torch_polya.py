"""nanopolish_tpu_torch `polya`, `detect-polyi` and `fast5-check` on the
CPU, against the frozen golden and the JAX apps.

The 3-read direct-RNA pipeline of tests/test_golden_outputs.py:244-291
(and tests/test_polya_e2e.py's) is rebuilt with the port's own writers.
Slow5 records load as DNA by default, so, as the JAX tests do, the port's
``Slow5Record.to_fast5_data`` is patched to report RNA: the reads then go
through the RNA branch of ingest (the RNA event detector, the r9.4_70bps
5-mer model, events reversed to 5'->3'), whose banded alignment gives the
TSV's read_rate column.  The outputs must be byte-identical: the golden
for polya, the JAX app's output for detect-polyi and fast5-check.
"""

import io
import os

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.__main__ import main as cli
from nanopolish_tpu_torch.apps import index as index_app
from nanopolish_tpu_torch.io.bam import BamRecord, BamWriter
from nanopolish_tpu_torch.io.slow5 import Slow5Record, Slow5Writer
from nanopolish_tpu_torch.models.pore_model import PoreModelSet
from nanopolish_tpu_torch.utils.synthetic import random_sequence

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLYA_NT = 120
SAMPLES_PER_BASE = 30.0
SAMPLE_RATE = 4000.0
TRANSCRIPT_LEN = 500


def _rna_read_signal(rng, transcript, model):
    """3'->5' raw signal: START | LEADER | ADAPTER | POLYA | transcript
    (tests/test_polya_e2e.py's recipe)."""
    parts = [
        rng.normal(70.3, 2.0, size=300),
        rng.normal(110.9, 2.0, size=400),
        rng.normal(79.3, 2.5, size=400),
        rng.normal(108.9, 1.5, size=int(POLYA_NT * SAMPLES_PER_BASE)),
    ]
    seq = transcript.replace("U", "T")
    ranks = model.alphabet.seq_to_kmer_ranks(seq, model.k)[::-1]
    nsamp = np.maximum(3, rng.poisson(SAMPLES_PER_BASE, size=len(ranks)))
    level = model.level_mean[ranks]
    stdv = model.level_stdv[ranks]
    parts.append(rng.normal(np.repeat(level, nsamp), np.repeat(stdv, nsamp)))
    return np.concatenate(parts).astype(np.float32)


def _pipeline(d, seed, prefix, n_reads=3):
    rng = np.random.default_rng(seed)
    model = PoreModelSet.instance().get_model(
        "r9.4_70bps", "u_to_t_rna", "template", 5)
    transcript = random_sequence(rng, TRANSCRIPT_LEN)
    ref_fa = str(d / "ref.fa")
    with open(ref_fa, "w") as fh:
        fh.write(">rna1\n")
        for i in range(0, TRANSCRIPT_LEN, 60):
            fh.write(transcript[i:i + 60] + "\n")
    fastq, slow5 = str(d / "reads.fastq"), str(d / "sig.slow5")
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for i in range(n_reads):
            fq.write(f"@{prefix}{i}\n{transcript}\n+\n{'I' * TRANSCRIPT_LEN}\n")
            pa = _rna_read_signal(rng, transcript, model)
            adc = np.clip(pa * 8192.0 / 1400.0, -32000, 32000).astype(np.int16)
            sw.write(f"{prefix}{i}", adc, 8192.0, 0.0, 1400.0, SAMPLE_RATE)
    index_app.main([fastq, "--slow5", slow5])
    bam = str(d / "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["rna1"],
                  [TRANSCRIPT_LEN])
    for i in range(n_reads):
        w.write(BamRecord(qname=f"{prefix}{i}", tid=0, pos=0, mapq=60,
                          cigar=[(0, TRANSCRIPT_LEN)], seq=transcript,
                          qual=np.full(TRANSCRIPT_LEN, 30, np.uint8)))
    w.close()
    return dict(ref_fa=ref_fa, fastq=fastq, bam=bam, slow5=slow5)


@pytest.fixture(scope="module")
def golden_pipe(tmp_path_factory):
    """tests/test_golden_outputs.py's polya_pipe (seed 97, reads grna*)."""
    return _pipeline(tmp_path_factory.mktemp("torch_golden_polya"), 97, "grna")


@pytest.fixture(scope="module")
def e2e_pipe(tmp_path_factory):
    """tests/test_polya_e2e.py's pipeline (seed 41, reads rna*)."""
    return _pipeline(tmp_path_factory.mktemp("torch_polya_e2e"), 41, "rna")


@pytest.fixture
def rna(monkeypatch):
    """Slow5 records report RNA, in the port and in the JAX package."""
    from nanopolish_tpu.io.slow5 import Slow5Record as JaxRecord
    for cls in (Slow5Record, JaxRecord):
        orig = cls.to_fast5_data

        def rna_to_fast5(self, kit="", experiment_type="dna", _orig=orig):
            return _orig(self, kit=kit, experiment_type="rna")

        monkeypatch.setattr(cls, "to_fast5_data", rna_to_fast5)


def _args(p):
    return ["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"]]


def _run_cli(capsys, argv):
    capsys.readouterr()
    rc = cli(argv)
    return rc, capsys.readouterr().out


def test_polya_golden_cli(golden_pipe, rna, capsys):
    """`python -m nanopolish_tpu_torch polya ... --device cpu` reproduces
    tests/golden/polya.tsv byte for byte."""
    rc, got = _run_cli(capsys, ["polya", *_args(golden_pipe),
                                "--device", "cpu"])
    assert rc == 0
    with open(os.path.join(ROOT, "tests", "golden", "polya.tsv")) as fh:
        want = fh.read()
    assert got == want


def test_detect_polyi_matches_jax(golden_pipe, rna, capsys):
    from nanopolish_tpu.apps import detect_polyi as jax_dpi
    want = io.StringIO()
    jax_dpi.main(_args(golden_pipe), stdout=want)
    rc, got = _run_cli(capsys, ["detect-polyi", *_args(golden_pipe),
                                "--device", "cpu"])
    assert rc == 0
    assert got == want.getvalue()
    assert len(got.splitlines()) == 4


def test_fast5_check_matches_jax(golden_pipe, capsys):
    from nanopolish_tpu.apps import fast5_check as jax_fc
    want = io.StringIO()
    want_rc = jax_fc.main(["-r", golden_pipe["fastq"]], stdout=want)
    rc, got = _run_cli(capsys, ["fast5-check", "-r", golden_pipe["fastq"]])
    assert (rc, got) == (want_rc, want.getvalue())
    assert rc == 0 and got.count("OK\t") == 3


def test_fast5_check_missing_signal_file(golden_pipe, tmp_path, capsys):
    """A readdb entry whose signal file is missing gives ERROR and rc 1,
    as in the JAX app."""
    from nanopolish_tpu.apps import fast5_check as jax_fc
    src = golden_pipe["fastq"]
    fastq = str(tmp_path / "reads.fastq")
    base = os.path.basename(src)
    for f in os.listdir(os.path.dirname(src)):
        if f.startswith(base) and f != base + ".index.readdb":
            with open(os.path.join(os.path.dirname(src), f), "rb") as a, \
                    open(str(tmp_path / f), "wb") as b:
                b.write(a.read())
    with open(fastq + ".index.readdb", "w") as fh:
        fh.write(f"*\t{tmp_path / 'missing.slow5'}\n")
    want = io.StringIO()
    want_rc = jax_fc.main(["-r", fastq], stdout=want)
    rc, got = _run_cli(capsys, ["fast5-check", "-r", fastq])
    assert rc == 1 and want_rc == 1
    assert got == want.getvalue()
    lines = got.splitlines()
    assert len(lines) == 3 and all(l.startswith("ERROR\t") for l in lines)


def test_polya_recovers_tail_length(e2e_pipe, rna):
    """tests/test_polya_e2e.py's recovery test on the port."""
    from nanopolish_tpu_torch.apps import polya as polya_app
    out = io.StringIO()
    polya_app.main(_args(e2e_pipe) + ["--device", "cpu"], stdout=out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("readname\tcontig\tposition\tleader_start")
    rows = [l.split("\t") for l in lines[1:]]
    assert len(rows) == 3
    n_pass = 0
    for f in rows:
        assert f[1] == "rna1"
        if f[9] != "PASS":
            continue
        n_pass += 1
        assert 80 <= float(f[8]) <= 170, f
        ls, as_, ps, ts = (float(f[3]), float(f[4]), float(f[5]), float(f[6]))
        assert ls < as_ < ps < ts
    assert n_pass >= 2


def test_detect_polyi_on_polya_reads(e2e_pipe, rna):
    """A pure poly(A) tail classifies as POLYA-ONLY (or NONE on short
    regions), never POLYI-ONLY."""
    from nanopolish_tpu_torch.apps import detect_polyi as dpi_app
    out = io.StringIO()
    dpi_app.main(_args(e2e_pipe) + ["--device", "cpu"], stdout=out)
    lines = out.getvalue().splitlines()
    assert lines[0].endswith("detected\tqc_tag")
    rows = [l.split("\t") for l in lines[1:]]
    assert rows
    for f in rows:
        if f[-1] == "PASS":
            assert f[9] in ("POLYA-ONLY", "NONE"), f


def test_bernoulli_segmentation_matches_jax():
    from nanopolish_tpu.apps import detect_polyi as jax_dpi
    from nanopolish_tpu_torch.apps import detect_polyi as dpi
    rng = np.random.default_rng(13)
    x = np.concatenate([rng.normal(108.5, 5.3, 400),
                        rng.normal(108.9, 3.3, 500)]).astype(np.float32)
    for start, stop in ((0, 900), (100, 850), (10, 90)):
        assert dpi.bernoulli_segmentation(x, 0.5, 1.02, start, stop) == \
            jax_dpi.bernoulli_segmentation(x, 0.5, 1.02, start, stop)
    for args in ((250, 700, 900), (10, 700, 900), (250, 0, 900)):
        assert dpi.post_boolhmm_detection_qc(*args) == \
            jax_dpi.post_boolhmm_detection_qc(*args)
