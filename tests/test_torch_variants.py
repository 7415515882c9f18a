"""nanopolish_tpu_torch `variants` / `variants --consensus` and `vcf2fasta`
on the CPU, against the frozen golden (tests/golden/consensus.vcf), the
JAX package's app and the port counterparts of tests/test_variants_e2e.py,
tests/test_variant_db.py and tests/test_indel_bias.py.

The corpora of tests/test_golden_outputs.py:166-199 and
tests/test_variants_e2e.py are rebuilt with the port's own writers and
synthetic-signal generator.  Forward scores go through logaddexp, whose
exp/log1p differ in the last bit between XLA and torch, so the VCFs are
held to the printed-output rule (tests/printed_output.py): every number
within one unit of its last printed digit, everything else identical, so
no call differs.  Within the port the two screening paths (array and
object) share one drain and must agree bit for bit.
"""

import io
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.alignment.alignment_db import AlignmentDB
from nanopolish_tpu_torch.apps import index as index_app
from nanopolish_tpu_torch.apps import variants as va
from nanopolish_tpu_torch.apps import vcf2fasta as v2f
from nanopolish_tpu_torch.io.bam import BamRecord, BamWriter
from nanopolish_tpu_torch.io.slow5 import Slow5Writer
from nanopolish_tpu_torch.io.vcf import Variant
from nanopolish_tpu_torch.models.haplotype import Haplotype
from nanopolish_tpu_torch.models.pore_model import PoreModelSet
from nanopolish_tpu_torch.models.squiggle import SquiggleScalings
from nanopolish_tpu_torch.models.variant_db import (CO_WITH_REPLACEMENT,
                                                    VariantGroup,
                                                    combinations)
from nanopolish_tpu_torch.utils.synthetic import (random_sequence,
                                                  synthetic_raw_signal)
from tests.printed_output import assert_agree

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "consensus.vcf")
SUB = {"A": "G", "C": "T", "G": "A", "T": "C"}
N_READS, DRAFT_LEN = 25, 360          # tests/test_variants_e2e.py:19-20


def _write_fa(path, name, seq):
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), 60):
            fh.write(seq[i:i + 60] + "\n")


def _corpus(d, rng, draft, reads, cigar, leader):
    """draft.fa, reads.fastq, sig.slow5 (signal of each read's sequence
    with a random shift) and aln.bam for reads = [(name, seq)], every read
    aligned at 0 with ``cigar``."""
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    draft_fa = str(d / "draft.fa")
    _write_fa(draft_fa, "tig1", draft)
    fastq, slow5 = str(d / "reads.fastq"), str(d / "sig.slow5")
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for name, seq in reads:
            fq.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
            sc = SquiggleScalings.from4(float(rng.uniform(-2, 2)), 1.0,
                                        0.0, 1.0)
            pa = synthetic_raw_signal(rng, seq, model, sc,
                                      samples_per_base=9.0, leader=leader,
                                      trailer=90)
            adc = np.clip(pa * 8192.0 / 1400.0, -32000,
                          32000).astype(np.int16)
            sw.write(name, adc, 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    bam = str(d / "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"], [len(draft)])
    for name, seq in reads:
        w.write(BamRecord(qname=name, tid=0, pos=0, mapq=60,
                          cigar=list(cigar), seq=seq,
                          qual=np.full(len(seq), 30, np.uint8)))
    w.close()
    return {"dir": d, "draft_fa": draft_fa, "fastq": fastq, "bam": bam}


@pytest.fixture(scope="module")
def golden_pipe(tmp_path_factory):
    """tests/test_golden_outputs.py:166-199."""
    rng = np.random.default_rng(31)
    PoreModelSet.instance()
    truth = random_sequence(rng, 300)
    draft = list(truth)
    draft[130] = SUB[draft[130]]
    return _corpus(tmp_path_factory.mktemp("torch_golden_cons"), rng,
                   "".join(draft), [(f"gc{i}", truth) for i in range(12)],
                   [(0, len(truth))], leader=400)


@pytest.fixture(scope="module")
def consensus_pipeline(tmp_path_factory):
    """tests/test_variants_e2e.py:23-82: a substitution at 120 and a
    deletion at 180 in the draft."""
    rng = np.random.default_rng(31)
    truth = random_sequence(rng, DRAFT_LEN)
    sub_pos, del_pos = 120, 180
    draft = list(truth)
    orig = draft[sub_pos]
    draft[sub_pos] = SUB[orig]
    del draft[del_pos]
    draft = "".join(draft)
    cigar = [(0, del_pos), (1, 1), (0, DRAFT_LEN - del_pos - 1)]
    p = _corpus(tmp_path_factory.mktemp("torch_cons_e2e"), rng, draft,
                [(f"r{i}", truth) for i in range(N_READS)], cigar,
                leader=450)
    p.update(truth=truth, draft=draft, sub_pos=sub_pos, orig=orig)
    return p


def _args(p, window):
    return ["-r", p["fastq"], "-b", p["bam"], "-g", p["draft_fa"], "-w",
            window]


def _run(p, window, extra, name):
    vcf = str(p["dir"] / f"{name}.vcf")
    va.main(_args(p, window) + ["-o", vcf, "--device", "cpu"] + extra)
    return vcf


def _polished(p, vcf):
    out = io.StringIO()
    v2f.main(["-g", p["draft_fa"], "--skip-checks", vcf], stdout=out)
    return out.getvalue().splitlines()[1]


def test_golden_consensus_vcf(golden_pipe):
    vcf = _run(golden_pipe, "tig1:0-299", ["--consensus", "-d", "5"],
               "golden")
    rep = assert_agree(open(vcf).read(), open(GOLDEN).read(),
                       "consensus.vcf")
    assert rep["flips"] == 0


def test_consensus_and_vcf2fasta_recover_truth(consensus_pipeline):
    p = consensus_pipeline
    vcf = _run(p, f"tig1:0-{DRAFT_LEN - 1}", ["--consensus", "-d", "10"],
               "polished")
    text = open(vcf).read()
    assert "##nanopolish_window=tig1:0-" in text
    keys = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            f = line.split("\t")
            keys.add((int(f[1]) - 1, f[3], f[4]))
            assert float(f[5]) > 0 and "TotalReads=" in f[7]
    assert (p["sub_pos"], p["draft"][p["sub_pos"]], p["orig"]) in keys
    BUF = 45
    assert p["truth"][BUF:DRAFT_LEN - BUF] in _polished(p, vcf)


def test_consensus_matches_jax_app(consensus_pipeline):
    """The slice as a whole: the port's VCF against the JAX package's on
    the same corpus, under the printed-output rule."""
    from nanopolish_tpu.apps import variants as jax_va
    p = consensus_pipeline
    args = _args(p, f"tig1:0-{DRAFT_LEN - 1}") + ["--consensus", "-d", "10"]
    want = io.StringIO()
    jax_va.main(args, stdout=want)
    got = io.StringIO()
    va.main(args + ["--device", "cpu"], stdout=got)
    assert_agree(got.getvalue(), want.getvalue(), "variants --consensus")


def test_consensus_table_mode_matches_jax_app(consensus_pipeline,
                                             monkeypatch):
    """NPT_LOGSUM=table (the reference's quantized logsum) on both sides:
    the screening's flushes through the indexed drain's table route."""
    from nanopolish_tpu.apps import variants as jax_va
    from tests.printed_output import jax_table_runs, table_mode_agree
    p = consensus_pipeline
    args = _args(p, f"tig1:0-{DRAFT_LEN - 1}") + ["--consensus", "-d", "10"]

    def jax_run():
        want = io.StringIO()
        jax_va.main(args, stdout=want)
        return want.getvalue()

    want_port, want_jax = jax_table_runs(jax_run, monkeypatch)
    got = io.StringIO()
    va.main(args + ["--device", "cpu"], stdout=got)
    table_mode_agree(got.getvalue(), want_port, want_jax,
                     "variants --consensus NPT_LOGSUM=table")


def test_vcf2fasta_window_checks(consensus_pipeline, tmp_path):
    bad = tmp_path / "bad.vcf"
    bad.write_text("##fileformat=VCFv4.2\n"
                   "##nanopolish_window=tig1:100-200\n"
                   "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    with pytest.raises(SystemExit):
        v2f.main(["-g", consensus_pipeline["draft_fa"], str(bad)],
                 stdout=io.StringIO())


def test_fix_homopolymers_no_harm(consensus_pipeline):
    p = consensus_pipeline
    vcf = _run(p, f"tig1:0-{DRAFT_LEN - 1}",
               ["--consensus", "--fix-homopolymers", "-d", "10"], "hp")
    BUF = 45
    assert p["truth"][BUF:DRAFT_LEN - BUF] in _polished(p, vcf)


def test_calculate_all_support(consensus_pipeline):
    p = consensus_pipeline
    vcf = _run(p, f"tig1:0-{DRAFT_LEN - 1}",
               ["--consensus", "--calculate-all-support", "-d", "10"], "sup")
    snp = [ln.split("\t") for ln in open(vcf) if not ln.startswith("#")
           and len(ln.split("\t")[3]) == 1 and len(ln.split("\t")[4]) == 1]
    assert snp
    info = snp[0][7]
    fracs = [float(x) for x in
             info.split("SupportFractionByBase=")[1].split(";")[0].split(",")]
    assert len(fracs) == 4 and abs(sum(fracs) - 1.0) < 0.05
    assert fracs["ACGT".index(snp[0][4])] > 0.5


def test_event_subsequences_batch_matches_scalar(consensus_pipeline):
    p = consensus_pipeline
    db = AlignmentDB(p["fastq"], p["draft_fa"], p["bam"], device="cpu")
    db.load_region("tig1", 0, DRAFT_LEN - 1)
    starts = np.arange(db.get_region_start(), db.get_region_end() - 21)
    stops = starts + 21
    batched = db.get_event_subsequences_batch("tig1", starts, stops)
    assert len(batched) == len(starts)
    for s, e, got in zip(starts, stops, batched):
        want = db.get_event_subsequences("tig1", int(s), int(e))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.sr is w.sr and g.strand == w.strand and g.rc == w.rc
            assert g.event_start_idx == w.event_start_idx
            assert g.event_stop_idx == w.event_stop_idx


# ---------------------------------------------------------------------------
# screening (tests/test_variants_e2e.py:168-425)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def screening_corpus(tmp_path_factory):
    """4 reads support the draft base at 120 and 8 the truth, all
    full-length M alignments, draft supporters first."""
    rng = np.random.default_rng(77)
    L, sub_pos = 240, 120
    truth = random_sequence(rng, L)
    draft = list(truth)
    orig = draft[sub_pos]
    draft[sub_pos] = SUB[orig]
    draft = "".join(draft)
    names = [f"a{i}" for i in range(4)] + [f"b{i}" for i in range(8)]
    seqs = [draft] * 4 + [truth] * 8
    p = _corpus(tmp_path_factory.mktemp("torch_screen"), rng, draft,
                list(zip(names, seqs)), [(0, L)], leader=450)
    db = AlignmentDB(p["fastq"], p["draft_fa"], p["bam"], device="cpu")
    db.load_region("tig1", 0, L - 1)
    p.update(db=db, draft=draft, truth=truth, sub_pos=sub_pos, orig=orig,
             names=names)
    return p


def _screening_setup(c):
    """(hap, events in name order, true variant, bogus variant, exact
    per-read deltas of a variant)."""
    db, sub_pos = c["db"], c["sub_pos"]
    cs, ce = sub_pos - 10, sub_pos + 11
    hap = Haplotype("tig1", cs, db.get_reference_substring("tig1", cs, ce))
    order = {n: i for i, n in enumerate(c["names"])}
    events = sorted(db.get_event_subsequences("tig1", cs, ce),
                    key=lambda e: order[e.sr.read_name])
    draft_base = c["draft"][sub_pos]
    true_var = Variant(ref_name="tig1", ref_position=sub_pos,
                       ref_seq=draft_base, alt_seq=c["orig"])
    bogus_var = Variant(ref_name="tig1", ref_position=sub_pos,
                        ref_seq=draft_base,
                        alt_seq=next(b for b in "ACGT"
                                     if b not in (draft_base, c["orig"])))

    def deltas(var):
        return np.asarray(_obj([(hap, var, [ev]) for ev in events]))
    return hap, events, true_var, bogus_var, deltas


def _obj(jobs, thr=None, chunk=8):
    return va.score_variants_batched(jobs, [], screen_threshold=thr,
                                     chunk_reads=chunk, device="cpu")


def _checkpoints(chunk_reads, n):
    """Cumulative read counts at which the screen checks its running sum
    (s, 3s, 7s, ... with s = chunk_reads // 2)."""
    s = max(1, chunk_reads // 2)
    out, tot = [], 0
    while tot < n:
        tot = min(tot + s, n)
        out.append(tot)
        s *= 2
    return out


def test_screening_truncation_boundaries(screening_corpus):
    hap, events, _, bogus_var, deltas = _screening_setup(screening_corpus)
    cum = np.cumsum(deltas(bogus_var))
    assert cum[-1] < 0
    exact = _obj([(hap, bogus_var, events)])[0]
    assert np.isclose(exact, cum[-1], rtol=0, atol=1e-5)
    n = len(events)
    thrs = sorted({t for c in cum if c < 0 for t in (-c - 1e-3, -c + 1e-3)}
                  | {1.0})
    for chunk in (2, 4, 8, 16):
        cps = _checkpoints(chunk, n)
        for thr in thrs:
            if thr <= 0:
                continue
            got = _obj([(hap, bogus_var, events)], float(thr), chunk)[0]
            assert got <= 0
            kill = next((cp for cp in cps if cum[cp - 1] <= -thr), None)
            want = cum[kill - 1] if kill is not None else cum[-1]
            assert np.isclose(got, want, rtol=0, atol=1e-5), (chunk, thr)
            ref_kill = next((i + 1 for i in range(n) if cum[i] <= -thr),
                            None)
            if kill is not None:
                assert ref_kill is not None and kill >= ref_kill


def test_screening_survivor_quality_exact(screening_corpus):
    hap, events, true_var, _, deltas = _screening_setup(screening_corpus)
    exact = _obj([(hap, true_var, events)])[0]
    assert exact > 0
    thr = -np.cumsum(deltas(true_var)).min() + 1.0
    for chunk in (2, 4, 8, 16):
        got = _obj([(hap, true_var, events)], float(thr), chunk)[0]
        assert np.isclose(got, exact, rtol=0, atol=1e-5)


def test_screening_dip_recovery_vs_reference(screening_corpus):
    hap, events, true_var, _, deltas = _screening_setup(screening_corpus)
    d = deltas(true_var)
    assert (d[:4] < 0).all() and (d[4:] > 0).all()
    cum = np.cumsum(d)
    exact = _obj([(hap, true_var, events)])[0]
    assert exact > 0 and np.isclose(exact, cum[-1], rtol=0, atol=1e-5)
    dip = -cum.min()
    ref_kill = int(np.argmax(cum <= -dip)) + 1
    for chunk in (2, 4, 8, 16):
        crossed = [cp for cp in _checkpoints(chunk, len(events))
                   if cum[cp - 1] <= -dip]
        got = _obj([(hap, true_var, events)], float(dip), chunk)[0]
        if crossed:
            assert crossed[0] >= ref_kill and got <= 0
            assert np.isclose(got, cum[crossed[0] - 1], rtol=0, atol=1e-5)
        else:
            assert np.isclose(got, exact, rtol=0, atol=1e-5) and got > 0


def _jobs(c):
    hap, events, true_var, bogus_var, _ = _screening_setup(c)
    jobs = [(hap, true_var, events), (hap, bogus_var, events)]
    # a variant whose ref does not match the haplotype: total -inf
    here = hap.sequence[true_var.ref_position - hap.ref_position]
    bad_ref = next(b for b in "ACGT" if b != here)
    jobs.append((hap, Variant(ref_name="tig1",
                              ref_position=true_var.ref_position,
                              ref_seq=bad_ref, alt_seq="A" if bad_ref != "A"
                              else "C"), events))
    return jobs


@pytest.mark.parametrize("thr", [None, 25.0, 100.0])
def test_array_screening_matches_object_path(screening_corpus, thr):
    """Both screening paths build the same indexed inputs for the same
    drain: totals bit-identical, with and without the threshold."""
    jobs = _jobs(screening_corpus)
    for chunk in (2, 8):
        obj = _obj(jobs, thr, chunk)
        arr = va.score_variants_batched_arrays(jobs, screen_threshold=thr,
                                               chunk_reads=chunk,
                                               device="cpu")
        assert arr is not None and obj == arr, (chunk, obj, arr)
        assert obj[2] == float("-inf")


def test_screening_totals_match_jax(screening_corpus):
    """The port's screening totals against the JAX package's on one
    corpus.  Each Forward score agrees within 2e-3 nats (XLA's exp/log1p
    against torch's, and XLA's f32 log in the transition table), and a
    total sums two scores per read, so the bar is 2 x 2e-3 nats per read
    scored.  Without a threshold every read is scored.  With one, a total
    within a last ulp of -threshold at a checkpoint could stop one chunk
    earlier or later on one side, so there the accept/reject decisions
    must agree and the accepted (untruncated) qualities meet the bar."""
    from nanopolish_tpu.alignment.alignment_db import AlignmentDB as JaxDB
    from nanopolish_tpu.apps import variants as jax_va
    from nanopolish_tpu.models.haplotype import Haplotype as JaxHap
    from nanopolish_tpu.io.vcf import Variant as JaxVariant

    c = screening_corpus
    db = JaxDB(c["fastq"], c["draft_fa"], c["bam"])
    db.load_region("tig1", 0, len(c["draft"]) - 1)
    jobs = _jobs(c)
    order = {n: i for i, n in enumerate(c["names"])}
    jax_jobs = []
    for hap, v, events in jobs:
        jev = sorted(db.get_event_subsequences(
            "tig1", hap.ref_position, hap.ref_position + len(hap.sequence)
            - 1), key=lambda e: order[e.sr.read_name])
        assert [(e.sr.read_name, e.event_start_idx, e.event_stop_idx)
                for e in jev] == [(e.sr.read_name, e.event_start_idx,
                                   e.event_stop_idx) for e in events]
        jax_jobs.append((JaxHap("tig1", hap.ref_position, hap.sequence),
                         JaxVariant(ref_name="tig1",
                                    ref_position=v.ref_position,
                                    ref_seq=v.ref_seq, alt_seq=v.alt_seq),
                         jev))
    n_reads = len(jobs[0][2])
    bar = 2 * 2e-3 * n_reads
    for thr in (None, 100.0):
        got = _obj(jobs, thr)
        want = jax_va.score_variants_batched(jax_jobs, [],
                                             screen_threshold=thr)
        for g, w in zip(got, want):
            assert (g > 0) == (w > 0)
            if thr is None or g > 0:
                assert g == w or abs(g - w) <= bar, (thr, g, w)
        d = [abs(g - w) for g, w in zip(got, want) if math.isfinite(w)]
        print(f"screening totals, threshold {thr}: max |port - JAX| = "
              f"{max(d):.3g} nats over {len(d)} jobs")


# ---------------------------------------------------------------------------
# variant_db (tests/test_variant_db.py) and CLI wiring
# (tests/test_indel_bias.py:71-102)
# ---------------------------------------------------------------------------

def _strs(combos):
    return [",".join(str(i) for i in c) for c in combos]


def test_combinations_without_replacement():
    assert _strs(combinations(1, 1)) == ["0"]
    assert _strs(combinations(2, 1)) == ["0", "1"]
    assert _strs(combinations(2, 2)) == ["0,1"]
    assert _strs(combinations(3, 2)) == ["0,1", "0,2", "1,2"]
    assert _strs(combinations(4, 4)) == ["0,1,2,3"]
    assert len(combinations(10, 4)) == math.comb(10, 4)


def test_combinations_with_replacement():
    assert _strs(combinations(1, 1, CO_WITH_REPLACEMENT)) == ["0"]
    assert _strs(combinations(2, 1, CO_WITH_REPLACEMENT)) == ["0", "1"]
    assert _strs(combinations(2, 2, CO_WITH_REPLACEMENT)) == \
        ["0,0", "0,1", "1,1"]
    assert _strs(combinations(3, 2, CO_WITH_REPLACEMENT)) == \
        ["0,0", "0,1", "0,2", "1,1", "1,2", "2,2"]


def test_variant_group_scores():
    vs = [Variant(ref_name="c", ref_position=i, ref_seq="A", alt_seq="T")
          for i in (5, 9)]
    g = VariantGroup(0, vs)
    c0, c1, c2 = (g.add_combination(vc) for vc in ([], [0], [0, 1]))
    g.set_read_strand("r1:0", False)
    g.set_read_strand("r2:0", True)
    for ci, s1, s2 in ((c0, -10.0, -12.0), (c1, -8.0, -11.0),
                       (c2, -9.0, -7.0)):
        g.set_combination_read_score(ci, "r1:0", s1)
        g.set_combination_read_score(ci, "r2:0", s2)
    sums = dict(g.get_read_sum_scores())
    expect = math.log(math.exp(-10) + math.exp(-8) + math.exp(-9))
    assert abs(sums["r1:0"] - expect) < 1e-9
    assert g.is_read_rc("r2:0") and not g.is_read_rc("r1:0")
    assert g.get_variants(g.get_combination(c2)) == vs


def test_cli_wires_indel_bias_and_p_skip(monkeypatch):
    """main() applies the mode's default bias (0.9 consensus, 0.8
    calling), the -i override and the --p-skip family to Opts."""
    captured = {}

    def fake_call(contig, s, e, alignments, opts, candidates=None):
        captured.update(bias=opts.indel_bias, probs=opts.probs(),
                        device=opts.device)
        return Haplotype(contig, s, "ACGT")

    monkeypatch.setattr(va, "call_variants_for_region", fake_call)
    monkeypatch.setattr(va, "AlignmentDB",
                        lambda *a, **k: type("A", (), {"_fai": None})())
    args = ["-r", "x.fq", "-b", "x.bam", "-g", "x.fa", "-w", "tig:0-4",
            "--device", "cpu"]
    va.main(args + ["--consensus"], stdout=io.StringIO())
    assert captured["bias"] == 0.9 and captured["device"].type == "cpu"
    assert captured["probs"] == dict(p_skip=0.0025, p_bad=0.001,
                                     p_skip_self=0.3, p_bad_self=None)
    va.main(args, stdout=io.StringIO())
    assert captured["bias"] == 0.8
    va.main(args + ["-i", "0.7", "--p-skip", "0.01", "--p-bad", "0.02",
                    "--p-skip-self", "0.4", "--p-bad-self", "0.05"],
            stdout=io.StringIO())
    assert captured["bias"] == 0.7
    assert captured["probs"] == dict(p_skip=0.01, p_bad=0.02,
                                     p_skip_self=0.4, p_bad_self=0.05)


def test_p_skip_overrides_reach_every_table(screening_corpus, monkeypatch):
    """The overrides change the screening drain's scores and the flat
    Forward and Viterbi of --fix-homopolymers, and the drain's scores
    match the JAX scan with the same TransitionKnobs."""
    from nanopolish_tpu.ops.profile_hmm import (TransitionKnobs,
                                                profile_hmm_forward)
    from nanopolish_tpu_torch.alignment import segments
    from nanopolish_tpu_torch.alignment.segments import (forward_segments,
                                                         make_segment,
                                                         viterbi_segments)
    from nanopolish_tpu_torch.ops.profile_hmm import make_transitions
    hap, events, true_var, _, _ = _screening_setup(screening_corpus)
    probs = dict(p_skip=0.05, p_bad=0.01, p_skip_self=0.5, p_bad_self=0.02)
    jobs = [(hap, true_var, events)]
    base = va.score_variants_batched_arrays(jobs, 0.9, device="cpu")
    alt = va.score_variants_batched_arrays(jobs, 0.9, device="cpu",
                                           probs=probs)
    assert base != alt
    assert alt == va.score_variants_batched(jobs, [], 0.9, device="cpu",
                                            probs=probs)
    ev = events[0]
    sr = ev.sr
    ranks = sr.base_model[0].alphabet.seq_to_kmer_ranks(hap.sequence, 6)
    seg = make_segment(sr, ev.strand, ranks, ev.event_start_idx,
                       ev.event_stop_idx)
    f0 = forward_segments([seg], 0.9, device="cpu")
    f1 = forward_segments([seg], 0.9, device="cpu", probs=probs)
    assert f0[0] != f1[0]
    seen = []
    prepare = segments.prepare_viterbi_inputs
    monkeypatch.setattr(segments, "prepare_viterbi_inputs",
                        lambda *a, **k: seen.append(a[8]) or prepare(*a, **k))
    viterbi_segments([seg], 0.9, device="cpu", probs=probs)
    np.testing.assert_array_equal(
        seen[0], make_transitions([seg.events_per_base], 0.9, **probs))
    try:
        TransitionKnobs.set(**probs)
        want = profile_hmm_forward(
            seg.levels[None], np.array([len(seg.levels)], np.int32),
            seg.mu[None], seg.sigma[None], np.log(seg.sigma)[None],
            np.array([len(seg.mu)], np.int32),
            np.array([seg.events_per_base], np.float32), flags=0,
            indel_bias=0.9)
    finally:
        TransitionKnobs.reset()
    assert abs(float(f1[0]) - float(np.asarray(want)[0])) <= 2e-3


def test_variants_cli_runs_and_vcf2fasta_is_host_only(golden_pipe):
    """python -m nanopolish_tpu_torch variants --device cpu, then
    vcf2fasta, which takes no --device and touches no card."""
    p = golden_pipe
    env = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    vcf = str(p["dir"] / "cli.vcf")
    r = subprocess.run([sys.executable, "-m", "nanopolish_tpu_torch",
                        "variants", *_args(p, "tig1:0-299"), "--consensus",
                        "-d", "5", "-o", vcf, "--device", "cpu"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert_agree(open(vcf).read(), open(GOLDEN).read(), "consensus.vcf (cli)")
    r = subprocess.run([sys.executable, "-m", "nanopolish_tpu_torch",
                        "vcf2fasta", "-g", p["draft_fa"], vcf], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(">tig1\n") and "rewrote contig tig1 with 1 " \
        "subs" in r.stderr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the indexed Forward kernel has no "
                    "CPU mode; its plain version is tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_consensus_gpu_matches_cpu(golden_pipe, cuda_device):
    outs = {}
    for dev in ("cpu", "cuda"):
        out = io.StringIO()
        va.main(_args(golden_pipe, "tig1:0-299") + ["--consensus", "-d", "5",
                                                     "--device", dev],
                stdout=out)
        outs[dev] = out.getvalue()
    assert_agree(outs["cuda"], outs["cpu"], "variants --consensus")
