"""nanopolish_tpu_torch's device chain (alignment/device_chain.py,
ops/chain_step.py) on the CPU, with NPT_EA_DEVICE_CHAIN=1 and --device
cpu: the chain's plain versions, held to the host wavefront and to the
JAX package.

  * closest_event_array equals the JAX function (the three densities of
    tests/test_eventalign_e2e.py);
  * eventalign's TSV through the chain is byte-identical to the port's
    host wavefront and to the JAX app on forward and reverse reads, and
    the goldens tests/golden/eventalign.tsv and eventalign_summary.tsv
    hold through it;
  * chain_prepare_plain and chain_consume_plain, round by round, equal
    the host _prepare and _consume (the Viterbi inputs, the paths at the
    chain's kmer width, the kept rows and the re-anchored chain),
    through last sections and beside jobs that have ended;
  * each fallback (a spliced job, a window over TP, a spent round
    budget) is counted in CHAIN_STATS and gives identical output;
  * the active count is read once every CHECK_EVERY rounds, the rows
    fetched once a batch;
  * under NPT_PROFILE, one eventalign call opens the host path's spans
    (the batch's decoding, the reads' load, the alignment, the chain's
    rounds and checks, the host wavefront), each with its parent, and
    prints the same TSV;
  * scorereads and methyltrain run on the chain's alignments, held on
    each call to the host wavefront's.
"""

import io
import os

import numpy as np
import pytest
import torch

from nanopolish_tpu.alignment.device_chain import \
    closest_event_array as jax_closest
from nanopolish_tpu_torch.alignment import device_chain as dc
from nanopolish_tpu_torch.alignment import eventalign as ea
from nanopolish_tpu_torch.alignment.segments import viterbi_segments
from nanopolish_tpu_torch.apps import eventalign as ea_app
from nanopolish_tpu_torch.apps import index as index_app
from nanopolish_tpu_torch.apps import methyltrain as mt
from nanopolish_tpu_torch.apps import scorereads as sc_app
from nanopolish_tpu_torch.io.bam import BamReader, BamRecord, BamWriter
from nanopolish_tpu_torch.io.fasta import FastaIndex
from nanopolish_tpu_torch.io.readdb import ReadDB
from nanopolish_tpu_torch.io.slow5 import Slow5Writer
from nanopolish_tpu_torch.models.pore_model import PoreModelSet
from nanopolish_tpu_torch.models.read_loader import load_squiggle_reads
from nanopolish_tpu_torch.models.squiggle import (SquiggleRead,
                                                  SquiggleScalings)
from nanopolish_tpu_torch.ops import chain_step as cs
from nanopolish_tpu_torch.ops.banded_align import emission_constant
from nanopolish_tpu_torch.ops.profile_hmm import paths_to_segments
from nanopolish_tpu_torch.utils import profiler
from nanopolish_tpu_torch.utils.alphabet import DNA_ALPHABET
from nanopolish_tpu_torch.utils.synthetic import (random_sequence,
                                                  synthetic_raw_signal)
from tests.test_torch_eventalign_golden import _check, ea_pipe  # noqa: F401
from tests.test_torch_methyltrain import _args as mt_args
from tests.test_torch_methyltrain import _run as mt_run
from tests.test_torch_methyltrain import build_corpus as mt_corpus

torch.set_num_threads(2)

GENOME_LEN = 2400
# (name, ref position, reverse, length): forward and reverse reads of
# different lengths, so that chains end in different rounds
PLAN = [("f0", 120, False, 360), ("r0", 900, True, 300),
        ("f1", 1400, False, 260), ("r1", 1900, True, 330)]
# the jobs of the align-level fallback cases: one forward, one reverse
SUBSET = ("f1", "r1")
# job slots of the refilled runs: fewer than the jobs
REFILL_SLOTS = 2


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chain")
    rng = np.random.default_rng(42)
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    genome = random_sequence(rng, GENOME_LEN)
    ref_fa = str(d / "ref.fa")
    with open(ref_fa, "w") as fh:
        fh.write(">tig1\n")
        for i in range(0, GENOME_LEN, 60):
            fh.write(genome[i:i + 60] + "\n")
    fastq, slow5 = str(d / "reads.fastq"), str(d / "sig.slow5")
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for name, pos, rev, n in PLAN:
            seg = genome[pos:pos + n]
            call = DNA_ALPHABET.reverse_complement(seg) if rev else seg
            fq.write(f"@{name}\n{call}\n+\n{'I' * n}\n")
            sc = SquiggleScalings.from4(float(rng.uniform(-3, 3)),
                                        float(rng.uniform(0.95, 1.05)),
                                        0.0, 1.0)
            pa = synthetic_raw_signal(rng, call, model, sc,
                                      samples_per_base=10.0, leader=500,
                                      trailer=120)
            sw.write(name, np.clip(pa * 8192.0 / 1400.0, -32000,
                                   32000).astype(np.int16),
                     8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    bam = str(d / "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"],
                  [GENOME_LEN])
    for name, pos, rev, n in sorted(PLAN, key=lambda p: p[1]):
        w.write(BamRecord(qname=name, flag=16 if rev else 0, tid=0, pos=pos,
                          mapq=60, cigar=[(0, n)], seq=genome[pos:pos + n],
                          qual=np.full(n, 30, np.uint8)))
    w.close()
    return {"ref_fa": ref_fa, "fastq": fastq, "bam": bam}


def _eventalign(p, mode, mp, extra=()):
    """The port's eventalign --device cpu with NPT_EA_DEVICE_CHAIN=mode;
    (TSV, CHAIN_STATS of the run)."""
    mp.setenv("NPT_EA_DEVICE_CHAIN", mode)
    dc.reset_chain_stats()
    out = io.StringIO()
    ea_app.main(["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"],
                 "--print-read-names", *extra, "--device", "cpu"],
                stdout=out)
    return out.getvalue(), dict(dc.CHAIN_STATS)


@pytest.fixture(scope="module")
def runs(pipe):
    """The pipeline's TSV from the host wavefront, from the chain and from
    the JAX app."""
    from nanopolish_tpu.apps import eventalign as jax_app
    with pytest.MonkeyPatch.context() as mp:
        host, _ = _eventalign(pipe, "0", mp)
        chain, stats = _eventalign(pipe, "1", mp)
        mp.setattr(dc, "CHAIN_BATCH", REFILL_SLOTS)
        refilled, refilled_stats = _eventalign(pipe, "1", mp)
    want = io.StringIO()
    jax_app.main(["-r", pipe["fastq"], "-b", pipe["bam"], "-g",
                  pipe["ref_fa"], "--print-read-names"], stdout=want)
    return {"host": host, "chain": chain, "stats": stats,
            "refilled": refilled, "refilled_stats": refilled_stats,
            "jax": want.getvalue()}


@pytest.mark.parametrize("density, n", [(0.9, 300), (0.05, 2500),
                                        (0.0005, 2500)])
def test_closest_event_array_matches_jax(density, n):
    rng = np.random.default_rng(5)
    b2e = np.full((n, 2), -1, np.int32)
    mask = rng.random(n) < density
    b2e[mask, 0] = np.arange(mask.sum(), dtype=np.int32) * 2
    got = dc.closest_event_array(b2e)
    np.testing.assert_array_equal(got, jax_closest(b2e))
    sr = SquiggleRead(read_name="x", read_sequence="A" * (n + 6))
    sr.base_to_event_map[0] = b2e
    for kidx in list(range(0, n, 37)) + [0, 1, n - 2, n - 1]:
        assert got[kidx] == sr.get_closest_event_to(kidx, 0)


def test_chain_tsv_equals_host_wavefront_and_jax_app(runs):
    st = runs["stats"]
    print(f"chain stats: {st}")
    assert st["chained"] == len(PLAN) and st["aborted"] == 0 and \
        st["ineligible"] == 0
    assert len(runs["chain"].splitlines()) > 1000
    assert runs["chain"] == runs["host"]
    assert runs["chain"] == runs["jax"]


def test_refilled_chain_tsv_equals_host_wavefront_and_jax_app(runs):
    """With fewer job slots than jobs, the queue's jobs take the slots
    the others free, and the TSV is the same, byte for byte."""
    st = runs["refilled_stats"]
    print(f"refilled chain stats: {st}")
    assert st["chained"] == len(PLAN) and st["aborted"] == 0 and \
        st["ineligible"] == 0
    assert st["refills"] == len(PLAN) - REFILL_SLOTS
    assert runs["stats"]["refills"] == 0
    # the same windows, in fewer slots
    for k in ("live_windows", "vit_cells", "path_steps"):
        assert st[k] == runs["stats"][k], k
    assert st["slot_rounds"] == REFILL_SLOTS * st["rounds"]
    assert runs["refilled"] == runs["host"] == runs["jax"]


def test_chain_reads_its_state_once_every_check_rounds(runs):
    """One active-count read every CHECK_EVERY rounds (queued jobs count
    as active), and the call's rows in one fetch after its last round,
    with one slot a job and with refilled slots."""
    for st in (runs["stats"], runs["refilled_stats"]):
        assert st["batches"] == 1
        assert st["checks"] == st["rounds"] // dc.CHECK_EVERY
        # the loop stopped at the first read that saw no active chain
        assert st["rounds"] % dc.CHECK_EVERY == 0
        assert st["rounds"] < dc.round_budget(GENOME_LEN * 10)
        assert st["slot_rounds"] == st["rounds"] * min(
            len(PLAN), dc.CHAIN_BATCH if st is runs["stats"]
            else REFILL_SLOTS)


# eventalign's span -> its parent on the main thread
EA_SPANS = {"ea.next_batch": "ea.pass", "ea.load_reads": "ea.pass",
            "ea.align": "ea.pass", "ea.chain_rounds": "ea.align",
            "ea.chain_check": "ea.align", "ea.wavefront": "ea.align",
            "read_loader.load_raw": "ea.load_reads",
            "read_builder.detect": "ea.load_reads",
            "read_builder.process_chunk": "ea.load_reads"}


def test_eventalign_spans_and_their_parents(pipe, runs, monkeypatch,
                                             tmp_path):
    for name, value in (("_scopes", {}), ("_self", {}), ("_records", [])):
        monkeypatch.setattr(profiler, name, value)
    monkeypatch.setenv("NPT_PROFILE", "1")
    monkeypatch.setenv("NPT_PROFILE_TRACE", str(tmp_path / "spans.json"))
    tsv, st = _eventalign(pipe, "1", monkeypatch)
    assert tsv == runs["chain"]
    spans = profiler.spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (root,) = by_name["ea.pass"]
    for name, parent in EA_SPANS.items():
        assert name in by_name, name
        for s in by_name[name]:
            assert s.parent.name == parent and s.tid == root.tid, name
            assert root.start <= s.start <= s.end <= root.end, name
    # a group of rounds before each active-count read, the last beside
    assert len(by_name["ea.chain_check"]) == st["checks"] >= 1
    assert len(by_name["ea.chain_rounds"]) == -(-st["rounds"] //
                                                dc.CHECK_EVERY)
    snap = profiler.snapshot()
    assert snap["ea.pass.self"][1] < snap["ea.pass"][1]


def test_goldens_through_the_chain(ea_pipe, monkeypatch):  # noqa: F811
    """The eventalign TSV and summary goldens (tests/golden/) through the
    chain; chip_smoke.py also holds eventalign.sam through it."""
    p = ea_pipe
    monkeypatch.setenv("NPT_EA_DEVICE_CHAIN", "1")
    dc.reset_chain_stats()
    summary = str(p["dir"] / "chain_summary.tsv")
    out = io.StringIO()
    ea_app.main(["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"],
                 "--print-read-names", "--summary", summary, "--device",
                 "cpu"], stdout=out)
    _check("eventalign.tsv", out.getvalue())
    _check("eventalign_summary.tsv", open(summary).read())
    assert dc.CHAIN_STATS["chained"] == 4 and dc.CHAIN_STATS["aborted"] == 0


@pytest.fixture(scope="module")
def loaded(pipe):
    """The pipeline's reads, loaded on the cpu once, and its records."""
    db = ReadDB()
    db.load(pipe["fastq"])
    reader = BamReader(pipe["bam"])
    recs = list(reader)
    reader.close()
    reads = load_squiggle_reads(sorted(r.qname for r in recs), db,
                                num_threads=1, device="cpu")
    return reads, recs, FastaIndex(pipe["ref_fa"])


def _jobs(loaded, spliced=None, names=None):
    """(read, record, strand, index) jobs; ``spliced`` replaces that
    read's record with a two-segment one."""
    reads, recs, _ = loaded
    jobs = []
    for i, rec in enumerate(recs):
        if names is not None and rec.qname not in names:
            continue
        if rec.qname == spliced:
            n = len(rec.seq)
            rec = BamRecord(qname=rec.qname, flag=rec.flag, tid=0,
                            pos=rec.pos, mapq=60,
                            cigar=[(0, 200), (3, 40), (0, n - 240)],
                            seq=rec.seq, qual=rec.qual)
        jobs.append((reads[rec.qname], rec, 0, i))
    return jobs


def _align(loaded, jobs, mode, mp):
    """align_reads_to_ref's columns with NPT_EA_DEVICE_CHAIN=mode, and
    the run's CHAIN_STATS."""
    mp.setenv("NPT_EA_DEVICE_CHAIN", mode)
    dc.reset_chain_stats()
    cols = ea.align_reads_to_ref(jobs, loaded[2], ["tig1"], columnar=True,
                                 device="cpu")
    return cols, dict(dc.CHAIN_STATS)


def _same_columns(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("ref_position", "event_idx", "state"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.rc == b.rc


@pytest.fixture(scope="module")
def host_subset(loaded):
    """SUBSET's columns from the host wavefront."""
    with pytest.MonkeyPatch.context() as mp:
        return _align(loaded, _jobs(loaded, names=SUBSET), "0", mp)[0]


def _rounds_against_host(loaded):
    """Step a ChainBatch of the pipeline's jobs (in CHAIN_BATCH slots)
    round by round beside the host _prepare and _consume of the same
    jobs: each job the round's chain_prepare_plain looked at (the slots'
    jobs and those it took from the queue) against the host _prepare's
    segment, in whatever slot holds it; the chain's paths (kmer width 128)
    against the host's (bucketed at 64 or 128); chain_consume_plain's
    kept rows and re-anchored chain against _consume's.  Returns what
    the rounds went through."""
    jobs_in, fai = _jobs(loaded), loaded[2]
    make = lambda: [ea._make_job(*j, fai, ["tig1"], -1, -1)  # noqa: E731
                    for j in jobs_in]
    host, chain = make(), make()
    batch = dc.ChainBatch([dc.stage_job(j) for j in chain],
                          torch.device("cpu"))
    host = [host[i] for i in batch.order]        # the batch's job order
    # idle: the jobs the rounds found without a window (each once, as it
    # leaves its slot); ended: rounds that left a slot without a job
    seen = {"last": 0, "idle": 0, "rounds": 0, "refills": 0, "ended": 0,
            "windows": 0}
    for _ in range(batch.max_rounds):
        sched0 = batch.sched.numpy().copy()
        batch.prepare()
        sched = batch.sched.numpy().copy()
        st = batch.state.numpy().copy()
        taken = list(range(sched0[0], sched[0]))
        looked = [b for b in sched0[1:] if b >= 0] + taken
        seen["refills"] += len(taken)
        segs = {b: ea._prepare(host[b]) for b in looked}
        seen["idle"] += sum(g is None for g in segs.values())
        slot_of = {int(b): s for s, b in enumerate(sched[1:]) if b >= 0}
        assert set(slot_of) == {b for b, g in segs.items() if g is not None}
        for b in range(batch.J):
            if b not in looked:                  # queued, or ended before
                assert st[b, cs.S_STRIDE] == 0
                assert (st[b, cs.S_STATUS] == cs.ACTIVE) == \
                    (b >= sched[0]), b
        if sched[0] < batch.J:                    # the queue fills slots
            assert len(slot_of) == batch.S
        if not slot_of:
            assert sched[0] == batch.J
            break
        seen["rounds"] += 1
        seen["windows"] += len(slot_of)
        seen["ended"] += int(len(slot_of) < batch.S)
        for b, seg in segs.items():
            if seg is None:
                assert st[b, cs.S_STRIDE] == 0
                assert st[b, cs.S_STATUS] != cs.ACTIVE
                continue
            j, s = host[b], slot_of[b]
            nev, nk = len(seg.levels), len(seg.mu)
            assert int(batch.n_events[s]) == nev
            assert int(batch.n_kmers[s]) == nk
            assert st[b, cs.S_STRIDE] == (1 if j.curr_start_event <=
                                          j._event_stop else -1)
            assert st[b, cs.S_LAST] == j._last_section
            seen["last"] += int(j._last_section)
            for got, want in (
                    (batch.levels[s, :nev], seg.levels),
                    (batch.mu[s, :nk], seg.mu),
                    (batch.sigma[s, :nk], seg.sigma),
                    (batch.c[s, :nk], emission_constant(np.log(seg.sigma))),
                    (batch.trans[s], batch.trans_all[b])):
                np.testing.assert_array_equal(
                    got.numpy().view(np.int32),
                    np.asarray(want, np.float32).view(np.int32))
        active = sorted(slot_of)
        results = viterbi_segments([segs[b] for b in active], device="cpu")
        batch.viterbi()
        paths = paths_to_segments(batch.path.numpy())
        for b, want in zip(active, results):
            got = paths[slot_of[b]]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2] == want[2]
        before = [len(j.out_ev) for j in host]
        cur0 = batch.state[:, cs.S_CURSOR].numpy().copy()
        batch.consume()
        for b, r in zip(active, results):
            ea._consume(host[b], r)
        st = batch.state.numpy()
        rows = batch.rows.numpy()
        for b in active:
            j = host[b]
            if len(j.out_ev) == before[b]:         # no row kept: ended
                assert st[b, cs.S_STATUS] == cs.DONE
                continue
            n = len(j.out_ev[-1])
            lo = batch.o_off[b] + cur0[b]
            np.testing.assert_array_equal(rows[0, lo:lo + n], j.out_ev[-1])
            np.testing.assert_array_equal(rows[1, lo:lo + n], j.out_ref[-1])
            np.testing.assert_array_equal(rows[2, lo:lo + n], j.out_st[-1])
            assert st[b, cs.S_CURSOR] == cur0[b] + n
            assert st[b, cs.S_STATUS] == cs.ACTIVE
            assert (st[b, cs.S_EV], st[b, cs.S_REF], st[b, cs.S_PAIR]) == (
                j.curr_start_event, j.curr_start_ref, j.curr_pair_idx)
    assert (batch.state[:, cs.S_STATUS] == cs.DONE).all()
    assert int(batch.state[:, cs.S_WINDOWS].sum()) == seen["windows"]
    print(f"captured rounds: {seen}, windows a job "
          f"{batch.state[:, cs.S_WINDOWS].tolist()}")
    return batch, seen


def test_plain_rounds_equal_host_prepare_and_consume(loaded):
    """Round by round on the same jobs, one slot a job: the Viterbi
    inputs, paths, kept rows and re-anchoring equal the host's, through
    last sections and beside jobs that have ended; the jobs run longest
    event range first."""
    batch, seen = _rounds_against_host(loaded)
    assert batch.S == batch.J == len(PLAN)
    assert seen["rounds"] == max(batch.state[:, cs.S_WINDOWS].tolist())
    assert [d.max_range for d in batch.djobs] == sorted(
        (d.max_range for d in batch.djobs), reverse=True)
    assert seen["rounds"] >= 8 and seen["last"] >= len(PLAN) and \
        seen["idle"] == len(PLAN) and seen["ended"] > 0 and \
        seen["refills"] == 0


def _list_schedule(windows, slots):
    """Rounds that jobs of these window counts take, in this order, in
    ``slots`` slots, each job taking the first slot to come free (its
    rounds back to back with its slot's last job's)."""
    free = [0] * slots
    for w in windows:
        i = free.index(min(free))
        free[i] += w
    return max(free)


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_refilled_plain_rounds_equal_host_prepare_and_consume(
        loaded, monkeypatch, slots):
    """As above with fewer slots than jobs: a slot whose job ended takes
    the queue's next job in the same round, and every job's windows are
    the host's, whichever round it started in."""
    monkeypatch.setattr(dc, "CHAIN_BATCH", slots)
    batch, seen = _rounds_against_host(loaded)
    assert batch.S == slots
    assert seen["refills"] == len(PLAN) - slots
    assert seen["last"] >= len(PLAN) and seen["idle"] == len(PLAN)
    # a slot takes its next job in the round after its last job's last
    # window: the rounds are the list schedule's, longest first
    windows = batch.state[:, cs.S_WINDOWS].tolist()
    assert seen["rounds"] == _list_schedule(windows, slots)


@pytest.mark.parametrize("fallback", ["window_over_tp", "round_budget",
                                      "queued_round_budget"])
def test_aborted_chains_fall_back_with_identical_output(loaded, host_subset,
                                                        monkeypatch,
                                                        fallback):
    if fallback == "window_over_tp":
        monkeypatch.setattr(dc, "TP", 8)
    else:
        monkeypatch.setattr(dc, "round_budget", lambda max_range: 2)
    if fallback == "queued_round_budget":
        # one slot: the second job waits for the first's abort, then has
        # its own budget of windows
        monkeypatch.setattr(dc, "CHAIN_BATCH", 1)
    cols, st = _align(loaded, _jobs(loaded, names=SUBSET), "1", monkeypatch)
    assert st["aborted"] == len(SUBSET) and st["chained"] == 0
    if fallback != "window_over_tp":
        assert st["live_windows"] == 2 * len(SUBSET)
        assert st["refills"] == (fallback == "queued_round_budget")
    _same_columns(cols, host_subset)


def test_spliced_job_is_ineligible_and_falls_back(loaded, host_subset,
                                                  monkeypatch):
    jobs = _jobs(loaded, spliced="r1", names=SUBSET)
    host, _ = _align(loaded, jobs[1:], "0", monkeypatch)
    cols, st = _align(loaded, jobs, "1", monkeypatch)
    assert st["ineligible"] == 1 and st["chained"] == 1
    _same_columns(cols, host_subset[:1] + host)
    assert len(cols[1].ref_position) > 200


@pytest.fixture(scope="module")
def mt_corpus_2(tmp_path_factory):
    """tests/test_torch_methyltrain.py's corpus cut to 2 reads (forward,
    reverse), with the unmethylated genome as a second reference."""
    d = str(tmp_path_factory.mktemp("torch_chain_mt"))
    c = mt_corpus(os.path.join(d, "corpus"), 2)
    c["plain_ref"] = os.path.join(d, "ref.fa")
    with open(c["ref"]) as src, open(c["plain_ref"], "w") as dst:
        dst.write(src.read().replace("M", "C"))
    return c


def _both_ways(mp, app):
    """Run ``app``'s align_reads_to_ref with the host wavefront and with
    the chain on every call, hold the two to each other and hand the
    chain's result on; returns the list of each call's CHAIN_STATS."""
    real = app.align_reads_to_ref
    calls = []

    def both(*a, **k):
        mp.setenv("NPT_EA_DEVICE_CHAIN", "0")
        host = real(*a, **k)
        mp.setenv("NPT_EA_DEVICE_CHAIN", "1")
        dc.reset_chain_stats()
        chain = real(*a, **k)
        calls.append(dict(dc.CHAIN_STATS))
        if k.get("columnar"):
            _same_columns(chain, host)
        else:
            assert chain == host
        return chain

    mp.setattr(app, "align_reads_to_ref", both)
    return calls


def test_scorereads_unchanged_with_the_chain(mt_corpus_2, monkeypatch):
    """scorereads prints from the chain's alignments, which equal the
    host wavefront's."""
    c = mt_corpus_2
    calls = _both_ways(monkeypatch, sc_app)
    out = io.StringIO()
    sc_app.main(["-r", c["fastq"], "-b", c["bam"], "-g", c["plain_ref"],
                 "--device", "cpu"], stdout=out)
    assert calls and all(st["chained"] == 2 for st in calls)
    assert sum(ln.startswith("SEGMENT\t")
               for ln in out.getvalue().splitlines())


def test_methyltrain_unchanged_with_the_chain(mt_corpus_2, tmp_path,
                                              monkeypatch):
    """One methyltrain round trains on the chain's alignments, which equal
    the host wavefront's."""
    calls = _both_ways(monkeypatch, mt)
    argv = mt_args(mt_corpus_2, "--rounds", "1", "--device", "cpu")
    _, rounds, _ = mt_run(mt, PoreModelSet, argv, str(tmp_path / "run"))
    assert calls and all(st["chained"] == 2 for st in calls)
    assert len(rounds) == 1 and rounds[0][:, 0].sum() > 500
