"""nanopolish_tpu_torch `call-methylation --device cpu` against the frozen
goldens (tests/golden/methylation.tsv, modbam_read.sam,
modbam_reference.sam) and against the JAX package's app.

The pipelines of tests/test_golden_outputs.py:123-155 and
tests/test_call_methylation_e2e.py:24-74 are rebuilt with the port's own
writers and synthetic-signal generator.  Forward scores go through
logaddexp, whose exp/log1p differ in the last bit between XLA and torch,
so outputs are held to the printed-output rule (tests/printed_output.py):
every number within one unit of its last printed digit, everything else
identical, no call flipped.  Each test prints how many rows differ.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.apps import call_methylation as cm
from nanopolish_tpu_torch.apps import index as index_app
from nanopolish_tpu_torch.io.bam import BamReader, BamRecord, BamWriter
from nanopolish_tpu_torch.io.slow5 import Slow5Writer
from nanopolish_tpu_torch.models.pore_model import PoreModelSet
from nanopolish_tpu_torch.models.squiggle import SquiggleScalings
from nanopolish_tpu_torch.utils.alphabet import (DNA_ALPHABET,
                                                 METHYL_CPG_ALPHABET)
from nanopolish_tpu_torch.utils.synthetic import (random_sequence,
                                                  synthetic_raw_signal)
from tests.printed_output import (assert_agree, compare, jax_table_runs,
                                  table_mode_agree)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
LLR = 5          # log_lik_ratio column of the TSV


def _write_fa(path, name, seq):
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), 60):
            fh.write(seq[i:i + 60] + "\n")


def _adc(pa):
    return np.clip(pa * 8192.0 / 1400.0, -32000, 32000).astype(np.int16)


def _corpus(d, rng, genome, plan, shift, leader):
    """ref/fastq/slow5/bam for plan = [(name, pos, is_rev, is_meth, len)];
    methylated reads draw their signal from the cpg model over the
    CpG-methylated basecall."""
    pms = PoreModelSet.instance()
    nuc = pms.get_model("r9.4_450bps", "nucleotide", "template", 6)
    cpg = pms.get_model("r9.4_450bps", "cpg", "template", 6)
    ref_fa = str(d / "ref.fa")
    _write_fa(ref_fa, "tig1", genome)
    fastq, slow5 = str(d / "reads.fastq"), str(d / "sig.slow5")
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for name, pos, is_rev, is_meth, L in plan:
            seg = genome[pos:pos + L]
            basecall = DNA_ALPHABET.reverse_complement(seg) if is_rev else seg
            fq.write(f"@{name}\n{basecall}\n+\n{'I' * L}\n")
            sc = SquiggleScalings.from4(shift, 1.0, 0.0, 1.0)
            if is_meth:
                pa = synthetic_raw_signal(
                    rng, METHYL_CPG_ALPHABET.methylate(basecall), cpg, sc,
                    samples_per_base=10.0, leader=leader, trailer=100)
            else:
                pa = synthetic_raw_signal(rng, basecall, nuc, sc,
                                          samples_per_base=10.0,
                                          leader=leader, trailer=100)
            sw.write(name, _adc(pa), 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    bam = str(d / "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"], [len(genome)])
    for name, pos, is_rev, _m, L in sorted(plan, key=lambda t: t[1]):
        seg = genome[pos:pos + L]
        w.write(BamRecord(qname=name, flag=16 if is_rev else 0, tid=0,
                          pos=pos, mapq=60, cigar=[(0, L)], seq=seg,
                          qual=np.full(L, 30, np.uint8)))
    w.close()
    return dict(dir=d, ref_fa=ref_fa, fastq=fastq, bam=bam, genome=genome)


@pytest.fixture(scope="module")
def meth_pipe(tmp_path_factory):
    """The golden recipe (tests/test_golden_outputs.py:123-155)."""
    rng = np.random.default_rng(77)
    genome = random_sequence(rng, 1000)
    plan = [("gm0", 60, False, True, 320), ("gu0", 380, False, False, 320),
            ("gm1", 600, True, True, 320)]
    return _corpus(tmp_path_factory.mktemp("torch_golden_meth"), rng, genome,
                   plan, shift=0.5, leader=400)


@pytest.fixture(scope="module")
def meth_pipeline(tmp_path_factory):
    """The JAX e2e recipe (tests/test_call_methylation_e2e.py:24-74)."""
    rng = np.random.default_rng(11)
    genome = random_sequence(rng, 2000)
    plan = [("m0", 100, False, True, 450), ("m1", 700, True, True, 450),
            ("u0", 400, False, False, 450), ("u1", 1100, True, False, 450)]
    return _corpus(tmp_path_factory.mktemp("torch_meth_e2e"), rng, genome,
                   plan, shift=0.0, leader=500)


def _args(p):
    return ["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"]]


def _run(p, *opts, device="cpu"):
    out = io.StringIO()
    cm.main(_args(p) + list(opts) + ["--device", device], stdout=out)
    return out.getvalue()


def _golden(name):
    return open(os.path.join(GOLDEN_DIR, name)).read()


def _render_bam(path):
    """Stable text rendering of a BAM (tests/test_golden_outputs.py:221)."""
    r = BamReader(path)
    lines = [r.header_text.rstrip("\n")]
    for rec in r:
        lines.append(rec.to_sam(r.references))
    r.close()
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("got, want, ok", [
    ("a\t-130.48\t12", "a\t-130.49\t12", True),   # one unit
    ("a\t-130.47\t12", "a\t-130.49\t12", False),  # two units
    ("a\t-130.48\t13", "a\t-130.48\t12", False),  # integers identical
    ("a\t0.01\t12", "a\t-0.00\t12", False),       # the call flips
    ("x -1.96123 y", "x -1.9612 y", True),         # %g drops a zero
    ("Ml:B:C,254,12", "Ml:B:C,253,12", True),
    ("Mm:Z:C+m?,15,5;", "Mm:Z:C+m?,15,6;", False),
    ("TGCA", "TGCC", False)])
def test_printed_output_rule(got, want, ok):
    assert (not compare(got, want, sign_cols=(1,))["breaches"]) == ok


def test_cli_cpu_matches_golden_tsv(meth_pipe):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "nanopolish_tpu_torch",
                        "call-methylation", *_args(meth_pipe),
                        "--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    rep = assert_agree(r.stdout, _golden("methylation.tsv"),
                       "methylation.tsv", sign_cols=(LLR,))
    assert rep["flips"] == 0 and rep["rows"] > 10


@pytest.mark.parametrize("style", ["read", "reference"])
def test_modbam_matches_golden(meth_pipe, tmp_path, style):
    modbam = str(tmp_path / f"mods_{style}.bam")
    tsv = _run(meth_pipe, "--modbam-output-name", modbam,
               "--modbam-style", style)
    assert_agree(tsv, _golden("methylation.tsv"), "methylation.tsv",
                 sign_cols=(LLR,))
    assert_agree(_render_bam(modbam), _golden(f"modbam_{style}.sam"),
                 f"modbam_{style}.sam", sam=True)


@pytest.mark.parametrize("opts", ["-q cpg", "-w tig1:1-800", "--shard 0/2",
                                  "--shard 1/2"])
def test_matches_jax_app(meth_pipeline, opts):
    """The options of tests/test_call_methylation_e2e.py against the JAX
    package's call-methylation (scan path on the CPU) on the same files."""
    from nanopolish_tpu.apps import call_methylation as jax_app
    want = io.StringIO()
    jax_app.main(_args(meth_pipeline) + opts.split(), stdout=want)
    got = _run(meth_pipeline, *opts.split())
    rep = assert_agree(got, want.getvalue(), f"call-methylation {opts}",
                       sign_cols=(LLR,))
    assert rep["flips"] == 0 and rep["rows"] > 1


def test_table_mode_matches_jax_app(meth_pipeline, monkeypatch):
    """NPT_LOGSUM=table (the reference's quantized logsum) on both sides."""
    from nanopolish_tpu.apps import call_methylation as jax_app

    def jax_run():
        want = io.StringIO()
        jax_app.main(_args(meth_pipeline), stdout=want)
        return want.getvalue()

    want_port, want_jax = jax_table_runs(jax_run, monkeypatch)
    got = _run(meth_pipeline)
    rep = table_mode_agree(got, want_port, want_jax,
                           "call-methylation NPT_LOGSUM=table",
                           sign_cols=(LLR,))
    assert rep["rows"] > 1
    monkeypatch.delenv("NPT_LOGSUM")
    assert got != _run(meth_pipeline)       # the table moves the scores


def test_methylated_reads_score_positive(meth_pipeline):
    """Reads whose signal came from the cpg model skew positive, the
    others negative (tests/test_call_methylation_e2e.py:77-110)."""
    rows = [ln.split("\t") for ln in _run(meth_pipeline).splitlines()[1:]]
    per_read = {}
    for f in rows:
        assert meth_pipeline["genome"][int(f[2]):int(f[2]) + 2] == "CG"
        per_read.setdefault(f[4], []).append(float(f[LLR]))
    assert {n[0] for n in per_read} == {"m", "u"}
    for name, llrs in per_read.items():
        mean = float(np.mean(llrs))
        assert (mean > 0.5) if name.startswith("m") else (mean < -0.5), \
            (name, mean)


@pytest.fixture(scope="module")
def straddle_pipe(tmp_path_factory):
    """CpGs spaced min_separation+1 apart put a motif one base outside
    every window (tests/test_call_methylation_e2e.py:295-324), forcing
    the per-window methylate branch."""
    rng = np.random.default_rng(23)
    genome = ("ATCAAT" * 10) + "ATTGATAGACG" * 60 + ("TTAGCA" * 10)
    plan = [("s0", 0, False, True, 400), ("s1", 150, True, False, 400),
            ("s2", 300, False, True, 400)]
    return _corpus(tmp_path_factory.mktemp("torch_meth_straddle"), rng,
                   genome, plan, shift=0.0, leader=500)


def _rows(block, reg, key):
    out = []
    for j in range(len(block["e1"])):
        buf = np.asarray(reg.rank_rows[int(block[f"{key}_src"][j])], np.int64)
        idx = int(block[f"{key}_start"][j]) + \
            np.arange(int(block["nk"][j])) * int(block["rstep"][j])
        out.append(buf[idx])
    return out


@pytest.mark.parametrize("corpus", ["meth_pipeline", "straddle_pipe"])
def test_native_geometry_matches_arrays(corpus, request):
    """csrc/meth_geometry.cpp and the NumPy array path give the same
    blocks, group for group, across the four methylation alphabets."""
    from nanopolish_tpu_torch.apps.bam_processor import BamBatchProcessor
    from nanopolish_tpu_torch.io.fasta import FastaIndex
    from nanopolish_tpu_torch.io.readdb import ReadDB
    from nanopolish_tpu_torch.models.read_loader import load_squiggle_reads
    from nanopolish_tpu_torch.utils.native import get_native_lib

    assert get_native_lib() is not None, "the native library must build"
    p = request.getfixturevalue(corpus)
    read_db = ReadDB()
    read_db.load(p["fastq"])
    fai = FastaIndex(p["ref_fa"])
    proc = BamBatchProcessor(p["bam"], batch_size=512, min_mapping_quality=20)
    batch = next(proc.batches())
    reads = load_squiggle_reads(sorted({r.qname for _, r in batch}), read_db,
                                num_threads=2, device="cpu")
    n_groups = 0
    for mtype in ("cpg", "gpc", "dam", "dcm"):
        params = cm.CallingParameters(methylation_type=mtype)
        for _, rec in batch:
            sr = reads.get(rec.qname)
            if sr is None:
                continue
            ref_seq = DNA_ALPHABET.disambiguate(
                fai.fetch(proc.references[rec.tid], rec.pos,
                          rec.reference_end() + 1).upper())
            reg_a, reg_n = cm._ScoreArrays(), cm._ScoreArrays()
            blocks_a = cm.collect_read_tasks_arrays(
                sr, rec, ref_seq, rec.pos, params, -1, -1, reg_a)
            blocks_n = cm.collect_read_tasks_native(
                sr, rec, ref_seq, rec.pos, params, -1, -1, reg_n)
            assert blocks_n is not None and len(blocks_a) == len(blocks_n)
            for ba, bn in zip(blocks_a, blocks_n):
                assert ba["strand_idx"] == bn["strand_idx"]
                assert ba["epb"] == bn["epb"]
                for key in ("e1", "estep", "nev", "nk", "start_pos",
                            "end_pos", "n_motif", "seq_lo", "seq_hi"):
                    np.testing.assert_array_equal(
                        np.asarray(ba[key], np.int64),
                        np.asarray(bn[key], np.int64), err_msg=key)
                for key in ("ru", "rm"):
                    for ra, rn in zip(_rows(ba, reg_a, key),
                                      _rows(bn, reg_n, key)):
                        np.testing.assert_array_equal(ra, rn)
                n_groups += len(ba["e1"])
    proc.close()
    assert n_groups > 40


def test_native_and_arrays_paths_print_the_same(straddle_pipe, monkeypatch):
    """The TSV is byte-identical whichever geometry path built it."""
    native = _run(straddle_pipe)
    monkeypatch.setattr(cm, "get_native_lib", lambda: None)
    arrays = _run(straddle_pipe)
    assert native == arrays and len(native.splitlines()) > 10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (call-methylation through the CUDA "
                    "kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gpu_matches_golden_tsv(meth_pipe, cuda_device):
    assert_agree(_run(meth_pipe, device="cuda"), _golden("methylation.tsv"),
                 "methylation.tsv", sign_cols=(LLR,))


# the three geometries that read --min-separation and --min-flank: the
# array path with csrc/meth_geometry.cpp, with its NumPy twin, and the
# object path (collect_read_tasks through ScoreBatcher)
GEOMETRIES = {"native": {}, "numpy": {"NPT_METH_NATIVE": "0"},
              "objects": {"NPT_METH_ARRAY": "0"}}


@pytest.fixture(scope="module")
def meth_default(meth_pipeline):
    """The port's TSV on meth_pipeline with no option."""
    return _run(meth_pipeline)


@pytest.mark.parametrize("case", ["min_separation_5", "min_flank_5",
                                  "batchsize_3", "min_mapping_quality_61",
                                  "models_fofn"])
def test_calling_options_match_jax_app(meth_pipeline, meth_default,
                                       tmp_path, case):
    """--min-separation, --min-flank, -K, --min-mapping-quality and
    --models-fofn against the JAX app, on each geometry, each shown to
    take effect: the TSV moves off the default run's, or (-K 3, whose
    output must not move) the reads go through in batches of 3 and 1."""
    from nanopolish_tpu.apps import call_methylation as jax_app
    from nanopolish_tpu_torch.apps.bam_processor import BamBatchProcessor
    from tests.model_files import (CPG, NUC, fresh_model_sets,
                                   shifted_models_fofn)
    opts = {"min_separation_5": ["--min-separation", "5"],
            "min_flank_5": ["--min-flank", "5"],
            "batchsize_3": ["-K", "3"],
            "min_mapping_quality_61": ["--min-mapping-quality", "61"],
            "models_fofn": ["--models-fofn", shifted_models_fofn(
                tmp_path, [NUC, CPG], 1.5)]}[case]
    default = meth_default
    sizes = []
    real = BamBatchProcessor.batches

    def spy(proc):
        for batch in real(proc):
            sizes.append(len(batch))
            yield batch

    with fresh_model_sets(), pytest.MonkeyPatch.context() as mp:
        want = io.StringIO()
        jax_app.main(_args(meth_pipeline) + opts, stdout=want)
        mp.setattr(BamBatchProcessor, "batches", spy)
        for geometry, env in GEOMETRIES.items():
            with pytest.MonkeyPatch.context() as ep:
                for k, v in env.items():
                    ep.setenv(k, v)
                del sizes[:]
                got = _run(meth_pipeline, *opts)
            rep = assert_agree(got, want.getvalue(),
                               f"call-methylation {case} ({geometry})",
                               sign_cols=(LLR,))
            assert rep["flips"] == 0
            if case == "batchsize_3":
                assert got == default and sizes == [3, 1]
            elif case == "min_mapping_quality_61":
                assert got.splitlines() == default.splitlines()[:1]
            else:
                assert got != default and rep["rows"] > 1
