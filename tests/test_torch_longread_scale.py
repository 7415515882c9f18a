"""Long reads and scale through nanopolish_tpu_torch on the CPU, held to
the JAX package's apps on the same files.

The corpora are the port's copies (utils/synthetic.build_longread_corpus,
build_scale_corpus) of tests/test_longread_hardening.py's and
tests/test_scale_hardening.py's fixtures, cut to a size the port's plain
versions run in Tier-1 time: one 2.5 kb read and two of 1 kb, and 20
reads of 1.2 kb over a 3 kb contig (depth ~8).  (The plain Viterbi runs one
segment a round for a long read, ~0.26 s a round on the CPU: a 12 kb
read's eventalign takes ~160 s.)  The full sizes run on the card in
chip_smoke.py.

Bar: once the JAX app takes the port's transition table
(_port_transitions_in_jax: the tables differ by a few ulp, and a
Viterbi tie within that can take the other path), eventalign,
call-methylation and variants --consensus print the same bytes.  The
JAX tests' own bars (b2e length, valid fraction, spans, row counts,
planted substitutions) hold at this size too, scaled to its lengths.

The ingest's device-memory split (models/read_builder._split_for_hbm) is
pinned here, as no corpus reaches its 4 GiB budget: with the budget
patched small in both packages, a chunk splits into the same parts in
both and gives b2e maps identical to the unsplit run.
"""

import io

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.apps import call_methylation as cm
from nanopolish_tpu_torch.apps import eventalign as ea
from nanopolish_tpu_torch.apps import variants as va
from nanopolish_tpu_torch.io.readdb import ReadDB
from nanopolish_tpu_torch.models import read_builder as rb
from nanopolish_tpu_torch.models.read_loader import load_squiggle_reads
from nanopolish_tpu_torch.utils.synthetic import (build_longread_corpus,
                                                  build_scale_corpus)
from tests.test_torch_scorereads_phase import _port_transitions_in_jax

torch.set_num_threads(2)

LR_LENGTHS = (2500, 1000, 1000)
SC_READS, SC_LEN, SC_GENOME, SC_WIN = 20, 1200, 3000, (1200, 1741)
# the split test's reads, and the budget in bands x reads at which they
# split into two chunks of 6 (B (T + K) is 12 x 3,584 for the whole chunk)
SPLIT_READS, SPLIT_BANDS = 12, 30_000


@pytest.fixture(scope="module")
def longread(tmp_path_factory):
    return build_longread_corpus(str(tmp_path_factory.mktemp("torch_lr")),
                                 LR_LENGTHS)


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    return build_scale_corpus(str(tmp_path_factory.mktemp("torch_scale")),
                              SC_READS, SC_LEN, SC_GENOME, SC_WIN)


def _both(port_app, jax_app, argv, monkeypatch):
    """(port's stdout on the cpu, the JAX app's stdout with the port's
    transition table)."""
    got = io.StringIO()
    port_app.main(argv + ["--device", "cpu"], stdout=got)
    with monkeypatch.context() as m:
        _port_transitions_in_jax(m)
        want = io.StringIO()
        jax_app.main(argv, stdout=want)
    return got.getvalue(), want.getvalue()


def _spans(lines, name_col, lo_col, hi_col):
    """Largest (max hi - min lo) over the reads of a TSV body."""
    by_read = {}
    for line in lines:
        f = line.split("\t")
        lo, hi = by_read.get(f[name_col], (1 << 60, -1))
        by_read[f[name_col]] = (min(lo, int(f[lo_col])),
                                max(hi, int(f[hi_col])))
    return {k: hi - lo for k, (lo, hi) in by_read.items()}


def test_longread_ingest_matches_jax(longread):
    """Every read survives ingest with a full base-to-event map
    (test_longread_hardening.py:86-105), equal to the JAX ingest's."""
    from nanopolish_tpu.io.readdb import ReadDB as JaxReadDB
    from nanopolish_tpu.models.read_loader import \
        load_squiggle_reads as jax_load
    names = [p[0] for p in longread["plan"]]
    db = ReadDB()
    db.load(longread["fastq"])
    got = load_squiggle_reads(names, db, num_threads=2, device="cpu")
    jdb = JaxReadDB()
    jdb.load(longread["fastq"])
    want = jax_load(names, jdb, num_threads=2)
    assert len(got) == len(want) == len(LR_LENGTHS)
    for name, _, _, rlen in longread["plan"]:
        b2e = got[name].base_to_event_map[0]
        assert b2e.shape[0] == rlen - 6 + 1
        assert (b2e[:, 0] >= 0).mean() > 0.98, name
        assert len(got[name].events[0]) > rlen
        np.testing.assert_array_equal(b2e, want[name].base_to_event_map[0])
        np.testing.assert_array_equal(got[name].events[0].mean,
                                      want[name].events[0].mean)


def test_longread_eventalign_matches_jax(longread, monkeypatch):
    from nanopolish_tpu.apps import eventalign as jax_app
    argv = ["-r", longread["fastq"], "-b", longread["bam"], "-g",
            longread["ref_fa"]]
    got, want = _both(ea, jax_app, argv, monkeypatch)
    assert got == want
    lines = got.splitlines()
    assert len(lines) > sum(LR_LENGTHS)
    spans = _spans(lines[1:], 2, 1, 1)
    assert max(spans.values()) > 0.99 * max(LR_LENGTHS)


def test_longread_call_methylation_matches_jax(longread, monkeypatch):
    from nanopolish_tpu.apps import call_methylation as jax_app
    argv = ["-r", longread["fastq"], "-b", longread["bam"], "-g",
            longread["ref_fa"], "-q", "cpg"]
    got, want = _both(cm, jax_app, argv, monkeypatch)
    assert got == want
    lines = [ln for ln in got.splitlines()[1:] if ln]
    # the JAX test's 3,000 rows over 220 kb, at this corpus's bases
    assert len(lines) > 3000 * sum(LR_LENGTHS) / 220_000
    assert max(_spans(lines, 4, 2, 3).values()) > 0.95 * max(LR_LENGTHS)


def test_scale_eventalign_summary_matches_jax(scale, tmp_path, monkeypatch):
    from nanopolish_tpu.apps import eventalign as jax_app
    base = ["-r", scale["fastq"], "-b", scale["bam"], "-g",
            scale["draft_fa"]]
    got = io.StringIO()
    ea.main(base + ["--summary", str(tmp_path / "port.tsv"), "--device",
                    "cpu"], stdout=got)
    with monkeypatch.context() as m:
        _port_transitions_in_jax(m)
        want = io.StringIO()
        jax_app.main(base + ["--summary", str(tmp_path / "jax.tsv")],
                     stdout=want)
    assert got.getvalue() == want.getvalue()
    summary = (tmp_path / "port.tsv").read_text()
    assert summary == (tmp_path / "jax.tsv").read_text()
    # the JAX test's 100,000 rows and 450 summaries of 500 x 1.2 kb reads
    assert len(got.getvalue().splitlines()) - 1 > 100_000 * SC_READS / 500
    assert len(summary.splitlines()) - 1 > 0.9 * SC_READS


def test_scale_call_methylation_matches_jax(scale, monkeypatch):
    from nanopolish_tpu.apps import call_methylation as jax_app
    argv = ["-r", scale["fastq"], "-b", scale["bam"], "-g",
            scale["draft_fa"], "-q", "cpg"]
    got, want = _both(cm, jax_app, argv, monkeypatch)
    assert got == want
    n_sites = sum(1 for ln in got.splitlines()
                  if ln and not ln.startswith("chromosome\t"))
    assert n_sites > 10_000 * SC_READS / 500


def test_scale_variants_matches_jax(scale, tmp_path, monkeypatch):
    from nanopolish_tpu.apps import variants as jax_app
    argv = ["-r", scale["fastq"], "-b", scale["bam"], "-g",
            scale["draft_fa"], "-w", f"tig1:{SC_WIN[0]}-{SC_WIN[1]}",
            "--consensus", "-d", "10"]
    va.main(argv + ["-o", str(tmp_path / "port.vcf"), "--device", "cpu"])
    with monkeypatch.context() as m:
        _port_transitions_in_jax(m)
        jax_app.main(argv + ["-o", str(tmp_path / "jax.vcf")])
    got = (tmp_path / "port.vcf").read_text()
    assert got == (tmp_path / "jax.vcf").read_text()
    keys = {(int(f[1]) - 1, f[3], f[4]) for f in
            (ln.split("\t") for ln in got.splitlines()
             if not ln.startswith("#"))}
    subs = scale["subs"]
    assert len(subs) >= 2
    recovered = sum((q, scale["draft"][q], scale["truth"][q]) in keys
                    for q in subs)
    assert recovered >= len(subs) - 1


def _recording(module):
    """Wrap module._split_for_hbm to record each top-level split as the
    read counts of its chunks."""
    real = module._split_for_hbm
    seen, depth = [], [0]

    def split(chunk):
        depth[0] += 1
        try:
            out = real(chunk)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            seen.append([len(c) for c in out])
        return out

    return split, seen


def _jax_budget(monkeypatch, fn, bands):
    """Set the JAX _split_for_hbm's inline 4 GiB budget (a constant of its
    code object) to bands x its 256 bytes a band."""
    code = fn.__code__
    consts = tuple(bands * 256 if c == 4 << 30 else c
                   for c in code.co_consts)
    assert consts != code.co_consts
    monkeypatch.setattr(fn, "__code__", code.replace(co_consts=consts))


def test_trace_budget_split_matches_unsplit_and_jax(scale, monkeypatch):
    """With the budget patched small in both packages, a 12-read chunk of
    the scale corpus splits into the same two chunks of 6 in both, and the
    b2e maps equal the unsplit run's and the JAX package's."""
    from nanopolish_tpu.io.readdb import ReadDB as JaxReadDB
    from nanopolish_tpu.models import read_builder as jrb
    from nanopolish_tpu.models.read_loader import \
        load_squiggle_reads as jax_load
    names = [p[0] for p in scale["plan"][:SPLIT_READS]]
    db = ReadDB()
    db.load(scale["fastq"])
    jdb = JaxReadDB()
    jdb.load(scale["fastq"])

    whole_split, whole = _recording(rb)
    monkeypatch.setattr(rb, "_split_for_hbm", whole_split)
    unsplit = load_squiggle_reads(names, db, num_threads=2, device="cpu")
    assert whole == [[SPLIT_READS]]

    monkeypatch.setattr(rb, "_TRACE_BUDGET",
                        SPLIT_BANDS * rb._TRACE_BYTES_PER_BAND)
    port_split, port_parts = _recording(rb)
    monkeypatch.setattr(rb, "_split_for_hbm", port_split)
    split = load_squiggle_reads(names, db, num_threads=2, device="cpu")
    _jax_budget(monkeypatch, jrb._split_for_hbm, SPLIT_BANDS)
    jax_split, jax_parts = _recording(jrb)
    monkeypatch.setattr(jrb, "_split_for_hbm", jax_split)
    want = jax_load(names, jdb, num_threads=2)

    assert port_parts == jax_parts == [[6, 6]]
    assert set(split) == set(unsplit) == set(want)
    assert len(split) > 0.9 * SPLIT_READS
    for name in split:
        b2e = split[name].base_to_event_map[0]
        np.testing.assert_array_equal(b2e, unsplit[name].base_to_event_map[0])
        np.testing.assert_array_equal(b2e, want[name].base_to_event_map[0])


@pytest.mark.parametrize("n_reads,read_len,jax_parts,port_parts", [
    (64, 100_000, 2, 1), (128, 100_000, 4, 1), (256, 30_000, 2, 1),
    (9, 100_000, 1, 1), (8, 400_000, 1, 1), (256, 300_000, 16, 2)])
def test_split_rule_matches_jax_at_its_budget(n_reads, read_len, jax_parts,
                                              port_parts, monkeypatch):
    """At the port's budget scaled to the JAX package's 256 trace bytes a
    band, the two _split_for_hbm rules part long-read chunks alike (only
    the lengths are read: ~1.8 events and one kmer a base); at its own
    33 bytes a band the port splits only chunks of much longer reads."""
    from nanopolish_tpu.models import read_builder as jrb
    work = [(i, None, range(int(1.8 * read_len) + i), None,
             range(read_len - 5 + i)) for i in range(n_reads)]
    want = [[w[0] for w in c] for c in jrb._split_for_hbm(work)]
    assert len(want) == jax_parts
    parts = rb._split_for_hbm(work)
    assert len(parts) == port_parts
    with monkeypatch.context() as m:
        m.setattr(rb, "_TRACE_BUDGET",
                  (4 << 30) * rb._TRACE_BYTES_PER_BAND // 256)
        assert [[w[0] for w in c] for c in rb._split_for_hbm(work)] == want
    for c in parts:
        T = rb._bucket_dims(max(len(w[2]) for w in c))
        K = rb._bucket_dims(max(len(w[4]) for w in c))
        assert len(c) <= 8 or \
            len(c) * (T + K) * rb._TRACE_BYTES_PER_BAND <= rb._TRACE_BUDGET
