"""nanopolish_tpu_torch `scorereads` and `phase-reads --device cpu` against
the JAX package's apps, on the phased corpus of
tests/test_phase_scorereads_e2e.py:23-82 rebuilt with the port's writers.

Both subcommands Forward-score segments, so their printed numbers are
held to the printed-output rule (tests/printed_output.py); the called
bases of phase-reads (SAM SEQ) must be identical.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.apps import index as index_app
from nanopolish_tpu_torch.apps import phase_reads as pr
from nanopolish_tpu_torch.apps import scorereads as sc
from nanopolish_tpu_torch.io.bam import BamRecord, BamWriter
from nanopolish_tpu_torch.io.slow5 import Slow5Writer
from nanopolish_tpu_torch.io.vcf import Variant, VcfWriter
from nanopolish_tpu_torch.models.pore_model import PoreModelSet
from nanopolish_tpu_torch.models.squiggle import SquiggleScalings
from nanopolish_tpu_torch.utils.synthetic import (build_deletion_corpus,
                                                  random_sequence,
                                                  synthetic_raw_signal)
from tests.printed_output import (assert_agree, jax_table_runs,
                                  table_mode_agree)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME_LEN = 1500
READ_LEN = 900


@pytest.fixture(scope="module")
def phased_pipeline(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_phase")
    rng = np.random.default_rng(21)
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    genome = random_sequence(rng, GENOME_LEN)
    ref_fa = str(d / "ref.fa")
    with open(ref_fa, "w") as fh:
        fh.write(">tig1\n")
        for i in range(0, GENOME_LEN, 60):
            fh.write(genome[i:i + 60] + "\n")
    snp_pos = 300
    ref_base = genome[snp_pos]
    alt_base = {"A": "C", "C": "G", "G": "T", "T": "A"}[ref_base]
    vcf = str(d / "vars.vcf")
    with open(vcf, "w") as fh:
        VcfWriter(fh).write_variant(Variant(
            ref_name="tig1", ref_position=snp_pos, ref_seq=ref_base,
            alt_seq=alt_base, quality=50, genotype="0/1"))
    # hap_alt carries the alt allele in its signal only; both basecalls
    # agree with the reference
    plan = [("hap_alt", True), ("hap_ref", False)]
    fastq, slow5 = str(d / "reads.fastq"), str(d / "sig.slow5")
    pos0 = 50
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for name, has_alt in plan:
            seg = genome[pos0:pos0 + READ_LEN]
            true_seq = seg
            if has_alt:
                i = snp_pos - pos0
                true_seq = seg[:i] + alt_base + seg[i + 1:]
            fq.write(f"@{name}\n{seg}\n+\n{'I' * READ_LEN}\n")
            pa = synthetic_raw_signal(rng, true_seq, model,
                                      SquiggleScalings.from4(0.0, 1.0, 0.0,
                                                             1.0),
                                      samples_per_base=10.0, leader=500,
                                      trailer=100)
            adc = np.clip(pa * 8192.0 / 1400.0, -32000, 32000).astype(np.int16)
            sw.write(name, adc, 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    bam = str(d / "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"], [GENOME_LEN])
    for name, _ in plan:
        w.write(BamRecord(qname=name, tid=0, pos=pos0, mapq=60,
                          cigar=[(0, READ_LEN)],
                          seq=genome[pos0:pos0 + READ_LEN],
                          qual=np.full(READ_LEN, 30, np.uint8),
                          tags={"NM": ("i", 0)}))
    w.close()
    return {"fastq": fastq, "bam": bam, "ref_fa": ref_fa, "vcf": vcf,
            "snp_pos": snp_pos, "pos0": pos0, "ref": ref_base,
            "alt": alt_base}


def _args(p):
    return ["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"]]


def _transitions(err: str) -> str:
    return err[err.index("Transition parameters for 0"):]


@pytest.mark.parametrize("opts", ["", "--calibrate", "--train-transitions"])
def test_scorereads_matches_jax_app(phased_pipeline, opts, capsys):
    from nanopolish_tpu.apps import scorereads as jax_app
    args = _args(phased_pipeline) + opts.split()
    want = io.StringIO()
    jax_app.main(args, stdout=want)
    want_err = capsys.readouterr().err
    got = io.StringIO()
    sc.main(args + ["--device", "cpu"], stdout=got)
    got_err = capsys.readouterr().err
    with capsys.disabled():
        rep = assert_agree(got.getvalue(), want.getvalue(),
                           f"scorereads {opts}")
    lines = got.getvalue().splitlines()
    assert rep["rows"] >= 4 and sum(ln.startswith("SEGMENT\t")
                                    for ln in lines) >= 2
    if opts == "--train-transitions":
        assert_agree(_transitions(got_err), _transitions(want_err),
                     "scorereads transition table")
        assert "matches=0" not in _transitions(got_err).split(
            "SUMMARY")[1].splitlines()[0]


def _port_transitions_in_jax(monkeypatch):
    """Give the JAX package's scan route the port's transition table.

    The port's table (ops/profile_hmm.make_transitions) is the JAX
    package's own Pallas-route table, _np_transitions, bit for bit (each
    log transition rounded once from f64;
    test_transition_table_is_jax_pallas_table).  The JAX scan route
    computes its table in f32 steps (1 - 1/epb, then 1 - p_stay - p_skip
    - p_bad) and XLA's log, which lands a few ulp away in lp_mm_self,
    lp_mm_next, lp_bk and lp_km
    (test_transition_table_differs_from_jax_by_a_few_ulp): the JAX
    package's two routes disagree there.  A Viterbi whose best path ties
    to within that can take the other path."""
    import jax.numpy as jnp
    from nanopolish_tpu.ops import profile_hmm as jph
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    cols = (0, 1, 2, 3, 4, 5, 5, 5, 6, 7)     # BlockTransitions field order

    def port_table(events_per_base, indel_bias=1.0, p_skip=None, p_bad=None,
                   p_bad_self=None, p_skip_self=None):
        knobs = jph.TransitionKnobs
        t = ph.make_transitions(
            np.asarray(events_per_base, np.float32), indel_bias,
            p_skip=knobs.p_skip if p_skip is None else p_skip,
            p_bad=knobs.p_bad if p_bad is None else p_bad,
            p_skip_self=(knobs.p_skip_self if p_skip_self is None
                         else p_skip_self),
            p_bad_self=knobs.p_bad_self if p_bad_self is None else p_bad_self)
        return jph.BlockTransitions(*[jnp.asarray(t[:, i]) for i in cols])

    monkeypatch.setattr(jph, "make_transitions", port_table)


@pytest.mark.parametrize("indel_bias", [1.0, 0.9])
def test_transition_table_is_jax_pallas_table(indel_bias):
    """The port's make_transitions is the JAX Pallas route's
    _np_transitions (nanopolish_tpu/ops/pallas_profile_hmm.py) bit for bit
    over a grid of events per base, below the 1.25 floor to 4."""
    from nanopolish_tpu.ops.pallas_profile_hmm import _np_transitions
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    epb = np.linspace(0.5, 4.0, 20001).astype(np.float32)
    got = ph.make_transitions(epb, indel_bias)
    want = _np_transitions(epb, indel_bias)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("indel_bias", [1.0, 0.9])
def test_transition_gap_is_the_scan_f32_steps_and_xla_log(indel_bias):
    """Where the JAX scan's table leaves the port's: redoing its f32 steps
    (max(1.25, epb * bias), 1 - 1/epb, then 1 - p_stay - p_skip - p_bad)
    under a correctly rounded log gives its lp_km exactly and its
    lp_mm_self, lp_mm_next and lp_bk to within 1 ulp; that last ulp is
    XLA's CPU f32 log, which is not correctly rounded."""
    from nanopolish_tpu.ops import profile_hmm as jph
    f = np.float32
    epb = np.linspace(0.5, 4.0, 20001).astype(f)
    j = jph.make_transitions(epb, indel_bias)
    e = np.maximum(f(1.25), epb * f(indel_bias))
    p_stay = f(1.0) - f(1.0) / e
    p_next = (f(1.0) - p_stay - f(0.0025)) - f(0.001)
    steps = {"lp_mm_self": p_stay, "lp_mm_next": p_next,
             "lp_bk": np.full_like(epb, (f(1.0) - f(0.001)) / f(3.0)),
             "lp_km": np.full_like(epb, f(1.0) - f(0.3))}
    for name, p in steps.items():
        emu = np.log(p.astype(np.float64)).astype(f)
        ulps = np.abs(emu.view(np.int32).astype(np.int64) -
                      np.asarray(getattr(j, name)).view(np.int32)
                      .astype(np.int64))
        assert ulps.max() <= (0 if name == "lp_km" else 1), name


def test_transition_table_differs_from_jax_by_a_few_ulp():
    """The port's transition table is the f64 one rounded once to f32.
    The JAX package's differs from it by a few ulp (at most 5 on this
    grid), and only in the four columns that it computes through f32
    steps and XLA's log."""
    from nanopolish_tpu.ops import profile_hmm as jph
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    epb = np.linspace(0.5, 4.0, 2001).astype(np.float32)
    for bias in (1.0, 0.9):
        got = ph.make_transitions(epb, bias)
        j = jph.make_transitions(epb, bias)
        want = np.stack([np.asarray(getattr(j, n)) for n in (
            "lp_mk", "lp_mb", "lp_mm_self", "lp_mm_next", "lp_bb", "lp_bk",
            "lp_kk", "lp_km")], axis=1)
        ulps = np.abs(got.view(np.int32).astype(np.int64) -
                      want.view(np.int32).astype(np.int64))
        assert ulps.max() <= 5
        assert not ulps[:, [0, 1, 4, 6]].any()
        e = np.maximum(1.25, epb.astype(np.float64) * bias)
        np.testing.assert_array_equal(
            got[:, 2], np.log(1.0 - 1.0 / e).astype(np.float32))


def test_scorereads_wide_chunk_matches_jax_app(tmp_path, monkeypatch):
    """A read with a dense run of 60-base deletions
    (utils/synthetic.build_deletion_corpus): one 500-event chunk spans
    1,384 reference kmers, which the port scores on its wide row instead
    of raising.  Every column of every row agrees with the JAX app under
    the printed-output rule, once both use one transition table
    (_port_transitions_in_jax): with its own, the JAX app's eventalign
    puts event 1474 at reference 1840 where the port puts it at 1838 (a
    Viterbi tie within the tables' difference), and the SEGMENT
    recalibration columns of that chunk follow."""
    from nanopolish_tpu.apps import scorereads as jax_app
    ref_fa, fastq, bam = build_deletion_corpus(str(tmp_path))
    args = ["-r", fastq, "-b", bam, "-g", ref_fa]
    seen = []
    tasks = sc._segment_tasks

    def spy(*a, **k):
        out = tasks(*a, **k)
        seen.extend(len(t["segment"].mu) for t in out)
        return out

    monkeypatch.setattr(sc, "_segment_tasks", spy)
    got = io.StringIO()
    sc.main(args + ["--device", "cpu"], stdout=got)
    assert max(seen) > 1024
    _port_transitions_in_jax(monkeypatch)
    want = io.StringIO()
    jax_app.main(args, stdout=want)
    rep = assert_agree(got.getvalue(), want.getvalue(),
                       "scorereads, wide chunk")
    assert rep["rows"] == len(seen) + 1


def test_scorereads_cli_scores_are_plausible(phased_pipeline):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "nanopolish_tpu_torch",
                        "scorereads", *_args(phased_pipeline), "--device",
                        "cpu"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    score_lines = [ln.split() for ln in r.stdout.splitlines()
                   if not ln.startswith("SEGMENT")]
    assert len(score_lines) == 2
    for f in score_lines:
        assert f[1] == "template" and f[4] == "shift"
        assert -4.0 < float(f[3]) < 0.0


def test_phase_reads_matches_jax_app(phased_pipeline):
    from nanopolish_tpu.apps import phase_reads as jax_app
    p = phased_pipeline
    args = _args(p) + [p["vcf"]]
    want = io.StringIO()
    jax_app.main(args, stdout=want)
    got = io.StringIO()
    pr.main(args + ["--device", "cpu"], stdout=got)
    assert_agree(got.getvalue(), want.getvalue(), "phase-reads", sam=True)
    calls = {}
    for line in got.getvalue().splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        i = p["snp_pos"] - p["pos0"]
        calls[f[0]] = (f[9][i], ord(f[10][i]) - 33)
    assert calls["hap_alt"][0] == p["alt"] and calls["hap_ref"][0] == p["ref"]
    assert calls["hap_alt"][1] > 3 and calls["hap_ref"][1] > 3


@pytest.mark.parametrize("app", ["scorereads", "phase-reads"])
def test_table_mode_matches_jax_app(phased_pipeline, app, monkeypatch):
    """NPT_LOGSUM=table (the reference's quantized logsum) on both sides."""
    from nanopolish_tpu.apps import phase_reads as jax_pr
    from nanopolish_tpu.apps import scorereads as jax_sc
    p = phased_pipeline
    args = _args(p) + ([p["vcf"]] if app == "phase-reads" else [])
    jax_app, port_app = {"scorereads": (jax_sc, sc),
                         "phase-reads": (jax_pr, pr)}[app]

    def jax_run():
        want = io.StringIO()
        jax_app.main(args, stdout=want)
        return want.getvalue()

    want_port, want_jax = jax_table_runs(jax_run, monkeypatch)
    got = io.StringIO()
    port_app.main(args + ["--device", "cpu"], stdout=got)
    table_mode_agree(got.getvalue(), want_port, want_jax,
                     f"{app} NPT_LOGSUM=table", sam=app == "phase-reads")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (Forward scoring through the CUDA "
                    "kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_phase_reads_gpu_matches_cpu(phased_pipeline, cuda_device):
    p = phased_pipeline
    outs = {}
    for dev in ("cpu", "cuda"):
        out = io.StringIO()
        pr.main(_args(p) + [p["vcf"], "--device", dev], stdout=out)
        outs[dev] = out.getvalue()
    assert_agree(outs["cuda"], outs["cpu"], "phase-reads", sam=True)


def test_scorereads_zero_drift_matches_jax_app(phased_pipeline, capsys,
                                              monkeypatch):
    """-z/--zero-drift: every recalibration leaves the drift out, so each
    SEGMENT line's drift column prints 0.00, the same way in the JAX
    app."""
    from nanopolish_tpu.apps import scorereads as jax_app
    args = _args(phased_pipeline) + ["-z"]
    want, got = io.StringIO(), io.StringIO()
    jax_app.main(args, stdout=want)
    drift = []
    real = sc.recalibrate_model

    def spy(sr, model, strand, aln, scale_var, scale_drift, **k):
        drift.append(scale_drift)
        return real(sr, model, strand, aln, scale_var, scale_drift, **k)

    monkeypatch.setattr(sc, "recalibrate_model", spy)
    sc.main(args + ["--device", "cpu"], stdout=got)
    capsys.readouterr()
    with capsys.disabled():
        rep = assert_agree(got.getvalue(), want.getvalue(), "scorereads -z")
    segments = [ln.split("\t") for ln in got.getvalue().splitlines()
                if ln.startswith("SEGMENT\t")]
    assert rep["rows"] >= 4 and len(segments) >= 2
    assert drift and not any(drift)
    assert {f[7] for f in segments} == {"0.00"}


def test_phase_reads_min_flanking_sequence_matches_jax_app(phased_pipeline,
                                                           monkeypatch):
    """--min-flanking-sequence 20 scores each SNP over 20 bases a side (41
    bases, 36 6-mers, where the default's 30 give 56), the same way in the
    JAX app."""
    from nanopolish_tpu.apps import phase_reads as jax_app
    p = phased_pipeline
    args = _args(p) + [p["vcf"], "--min-flanking-sequence", "20"]
    want, got = io.StringIO(), io.StringIO()
    jax_app.main(args, stdout=want)
    widths = set()
    real = pr.forward_segments

    def spy(tasks, *a, **k):
        widths.update(len(t.mu) for t in tasks)
        return real(tasks, *a, **k)

    monkeypatch.setattr(pr, "forward_segments", spy)
    pr.main(args + ["--device", "cpu"], stdout=got)
    assert_agree(got.getvalue(), want.getvalue(),
                 "phase-reads --min-flanking-sequence 20", sam=True)
    assert widths == {2 * 20 + 1 - 6 + 1}


def test_scorereads_individual_reads_matches_jax_app(phased_pipeline,
                                                     capsys):
    """-i/--individual-reads scores only the named reads: one of the two
    reads' lines, the same as the JAX app's."""
    from nanopolish_tpu.apps import scorereads as jax_app
    args = _args(phased_pipeline) + ["-i", "hap_ref"]
    want, got = io.StringIO(), io.StringIO()
    jax_app.main(args, stdout=want)
    sc.main(args + ["--device", "cpu"], stdout=got)
    capsys.readouterr()
    with capsys.disabled():
        assert_agree(got.getvalue(), want.getvalue(), "scorereads -i")
    names = {ln.split("\t")[1] if ln.startswith("SEGMENT\t")
             else ln.split()[0] for ln in got.getvalue().splitlines()}
    assert names == {"hap_ref"}
