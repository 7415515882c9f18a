"""nanopolish_tpu_torch `call-methylation --watch` against its direct run
and the JAX app's, in the layout of tests/test_call_methylation_e2e.py's
watch test: a fastq_pass/slow5_pass run directory, chunks sharded by
numeric suffix over two processes, and a stub mapper script that prints
the known alignments as SAM (so minimap2 is not needed).
"""

import io
import os
import shutil
import stat

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.apps import call_methylation as cm
from nanopolish_tpu_torch.io.bam import BamReader
from nanopolish_tpu_torch.utils.synthetic import random_sequence
from tests.test_torch_call_methylation import _corpus

torch.set_num_threads(2)

GENOME_LEN = 2000


@pytest.fixture(scope="module")
def meth_pipeline(tmp_path_factory):
    """The JAX e2e recipe (tests/test_call_methylation_e2e.py:24-74)."""
    rng = np.random.default_rng(11)
    genome = random_sequence(rng, GENOME_LEN)
    plan = [("m0", 100, False, True, 450), ("m1", 700, True, True, 450),
            ("u0", 400, False, False, 450), ("u1", 1100, True, False, 450)]
    return _corpus(tmp_path_factory.mktemp("torch_watch"), rng, genome, plan,
                   shift=0.0, leader=500)


def _run_dir(p, tmp_path):
    """run/fastq_pass/chunk_{0,1}.fastq and run/slow5_pass/chunk_0.slow5,
    and a stub mapper that prints the corpus's alignments."""
    run = tmp_path / "run"
    fqd, sgd = run / "fastq_pass", run / "slow5_pass"
    fqd.mkdir(parents=True)
    sgd.mkdir()
    shutil.copy(p["fastq"], fqd / "chunk_0.fastq")
    shutil.copy(os.path.join(os.path.dirname(p["fastq"]), "sig.slow5"),
                sgd / "chunk_0.slow5")
    # suffix 1: the other process's chunk, skipped here
    shutil.copy(p["fastq"], fqd / "chunk_1.fastq")
    r = BamReader(p["bam"])
    sam = ["@HD\tVN:1.6\tSO:unsorted", f"@SQ\tSN:tig1\tLN:{GENOME_LEN}"]
    sam += [rec.to_sam(r.references) for rec in r]
    r.close()
    (tmp_path / "aln.sam").write_text("\n".join(sam) + "\n")
    mapper = tmp_path / "fake_minimap2"
    mapper.write_text(f"#!/bin/sh\ncat {tmp_path / 'aln.sam'}\n")
    mapper.chmod(mapper.stat().st_mode | stat.S_IXUSR)
    return run, fqd, str(mapper)


def test_watch_matches_direct_runs(meth_pipeline, tmp_path):
    from nanopolish_tpu.apps import call_methylation as jax_app
    p = meth_pipeline
    run, fqd, mapper = _run_dir(p, tmp_path)
    rc = cm.main(["-g", p["ref_fa"], "-q", "cpg", "--watch", str(run),
                  "--watch-once", "--watch-process-total", "2",
                  "--watch-process-index", "0", "--watch-mapper", mapper,
                  "--watch-mapper-opts", "", "--device", "cpu"])
    assert rc == 0
    out_tsv = fqd / "chunk_0.fastq.meth.tsv"
    assert out_tsv.exists()
    assert not (fqd / "chunk_1.fastq.meth.tsv").exists()
    assert not (fqd / "chunk_0.fastq.meth.tsv.tmp").exists()
    watch = out_tsv.read_text()

    args = ["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"], "-q", "cpg"]
    direct = io.StringIO()
    cm.main(args + ["--device", "cpu"], stdout=direct)
    assert sorted(watch.splitlines()) == sorted(direct.getvalue().splitlines())
    want = io.StringIO()
    jax_app.main(args, stdout=want)
    assert sorted(watch.splitlines()) == sorted(want.getvalue().splitlines())
    assert len(watch.splitlines()) > 10

    # a second pass finds chunk 0 done and rewrites nothing
    mtime = out_tsv.stat().st_mtime_ns
    assert cm.main(["-g", p["ref_fa"], "--watch", str(run), "--watch-once",
                    "--watch-process-total", "2", "--watch-process-index",
                    "0", "--watch-mapper", mapper, "--watch-mapper-opts", "",
                    "--device", "cpu"]) == 0
    assert out_tsv.stat().st_mtime_ns == mtime


def test_watch_other_process_takes_chunk_1(meth_pipeline, tmp_path):
    """Process 1 of 2 is assigned chunk_1 only (numeric suffix mod N)."""
    p = meth_pipeline
    run, fqd, mapper = _run_dir(p, tmp_path)
    opt = cm.make_parser().parse_args(
        ["-g", p["ref_fa"], "--watch", str(run), "--watch-process-total",
         "2", "--watch-process-index", "1"])
    assert cm._discover_watch_work(opt) == [str(fqd / "chunk_1.fastq")]
    opt.watch_process_index = 0
    assert cm._discover_watch_work(opt) == [str(fqd / "chunk_0.fastq")]


def test_watch_without_mapper_raises(meth_pipeline, tmp_path):
    from nanopolish_tpu.apps import call_methylation as jax_app
    p = meth_pipeline
    run, _, _ = _run_dir(p, tmp_path)
    argv = ["-g", p["ref_fa"], "--watch", str(run), "--watch-once",
            "--watch-mapper", "no_such_mapper_npt"]
    with pytest.raises(SystemExit) as got:
        cm.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jax_app.main(argv)
    assert str(got.value) == str(want.value)
    assert "requires a mapper executable" in str(got.value)
    assert "'no_such_mapper_npt' not found in PATH" in str(got.value)


def test_reads_and_bam_required_without_watch(meth_pipeline):
    with pytest.raises(SystemExit, match="-r/--reads and -b/--bam"):
        cm.main(["-g", meth_pipeline["ref_fa"], "--device", "cpu"])


def test_watch_flags_are_the_jax_apps():
    """The two parsers take the same flags, plus --device in the port."""
    from nanopolish_tpu.apps import call_methylation as jax_app

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert flags(cm.make_parser()) - flags(jax_app.make_parser()) == \
        {"--device"}
    assert flags(jax_app.make_parser()) <= flags(cm.make_parser())
