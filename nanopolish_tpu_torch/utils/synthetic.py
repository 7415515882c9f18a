"""Synthetic squiggle generation for tests and benchmarks.

The reference's unit tests build a fake SquiggleRead with known scalings and
sample event levels from the scaled model Gaussians
(reference: src/test/nanopolish_test.cpp:277-325).  This module generalizes
that into a full fake-signal backend: sequence -> per-kmer dwell times ->
raw samples / event tables, so every stage of the pipeline can be tested
without real flowcell data.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..models.pore_model import PoreModel
from ..models.squiggle import EventTable, SquiggleRead, SquiggleScalings, SRNT_DNA, T_IDX


def random_sequence(rng: np.random.Generator, length: int, bases: str = "ACGT") -> str:
    return "".join(rng.choice(list(bases), size=length))


def synthetic_events(
    rng: np.random.Generator,
    sequence: str,
    model: PoreModel,
    scalings: SquiggleScalings,
    events_per_base: float = 1.8,
    sample_rate: float = 4000.0,
    samples_per_event: float = 8.0,
) -> EventTable:
    """Sample an event table from the scaled model Gaussians, with stays."""
    k = model.k
    ranks = model.alphabet.seq_to_kmer_ranks(sequence, k)
    n_kmers = len(ranks)
    counts = np.maximum(1, rng.poisson(events_per_base - 1, size=n_kmers) + 1)
    kmer_idx = np.repeat(np.arange(n_kmers), counts)
    r = ranks[kmer_idx]
    mean_clean = scalings.scale * model.level_mean[r] + scalings.shift
    stdv = model.level_stdv[r] * scalings.var
    durations = np.maximum(1, rng.poisson(samples_per_event, size=len(r))) / sample_rate
    start_time = np.concatenate([[0.0], np.cumsum(durations)[:-1]])
    levels = rng.normal(mean_clean, stdv) + scalings.drift * start_time
    ev_stdv = np.abs(rng.normal(1.0, 0.3, size=len(r))).astype(np.float32) + 0.3
    return EventTable(
        mean=levels.astype(np.float32),
        stdv=ev_stdv,
        start_time=start_time.astype(np.float32),
        duration=durations.astype(np.float32),
    )


def synthetic_raw_signal(
    rng: np.random.Generator,
    sequence: str,
    model: PoreModel,
    scalings: SquiggleScalings,
    sample_rate: float = 4000.0,
    samples_per_base: float = 10.0,
    noise_stdv_factor: float = 1.0,
    leader: int = 0,
    trailer: int = 0,
) -> np.ndarray:
    """Sequence -> raw pA samples (piecewise-constant levels + Gaussian noise).

    Optional low-variance leader/trailer stalls exercise MAD trimming.
    """
    k = model.k
    ranks = model.alphabet.seq_to_kmer_ranks(sequence, k)
    nsamp = np.maximum(3, rng.poisson(samples_per_base, size=len(ranks)))
    level = scalings.scale * model.level_mean[ranks] + scalings.shift
    stdv = model.level_stdv[ranks] * scalings.var * noise_stdv_factor
    sig = rng.normal(np.repeat(level, nsamp), np.repeat(stdv, nsamp))
    parts = [sig]
    if leader > 0:
        parts.insert(0, rng.normal(100.0, 0.05, size=leader))
    if trailer > 0:
        parts.append(rng.normal(100.0, 0.05, size=trailer))
    return np.concatenate(parts).astype(np.float32)


def synthetic_read(
    rng: np.random.Generator,
    model: PoreModel,
    sequence: Optional[str] = None,
    seq_length: int = 500,
    scalings: Optional[SquiggleScalings] = None,
    events_per_base: float = 1.8,
    read_name: str = "synthetic",
) -> SquiggleRead:
    """A fully-populated fake SquiggleRead (events pre-segmented)."""
    if sequence is None:
        sequence = random_sequence(rng, seq_length)
    if scalings is None:
        scalings = SquiggleScalings.from4(
            shift=rng.uniform(-10, 10), scale=rng.uniform(0.9, 1.1),
            drift=0.0, var=rng.uniform(0.9, 1.2))
    ev = synthetic_events(rng, sequence, model, scalings, events_per_base)
    read = SquiggleRead(
        read_name=read_name,
        read_sequence=sequence,
        nucleotide_type=SRNT_DNA,
        sample_rate=4000.0,
    )
    read.events[T_IDX] = ev
    read.scalings[T_IDX] = scalings
    read.base_model[T_IDX] = model
    n_kmers = len(sequence) - model.k + 1
    read.events_per_base[T_IDX] = len(ev) / n_kmers
    return read


def _write_fasta(path: str, name: str, seq: str) -> None:
    """One record, 60 bases a line."""
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), 60):
            fh.write(seq[i:i + 60] + "\n")


def _signal_adc(pa: np.ndarray) -> np.ndarray:
    """pA -> int16 ADC counts at digitisation 8192, range 1400, offset 0."""
    return np.clip(pa * 8192.0 / 1400.0, -32000, 32000).astype(np.int16)


# the read of build_deletion_corpus: 600 bases, then 30 runs of 12 bases
# each after a 60-base deletion, then 640 bases
DELETION_KEEP = ((0, 600),) + tuple((660 + 72 * i, 672 + 72 * i)
                                    for i in range(30)) + ((2760, 3400),)


def build_deletion_corpus(d: str, seed: int = 61, genome_len: int = 3500,
                          keep=DELETION_KEEP) -> Tuple[str, str, str]:
    """Reference FASTA, basecalls, slow5 signal, readdb index and BAM in
    directory d for one read whose molecule is genome[a:b] for the (a, b)
    of keep, mapped with a BAM record of M runs and the deletions between
    them.  eventalign follows 60-base deletions, so scorereads' 500-event
    chunks across the dense run of them span 1,384 reference kmers: past
    the 1,024 of one block (the profile-HMM kernels' wide row).  Returns
    (reference, fastq, bam) paths."""
    from ..apps import index as index_app
    from ..io.bam import BamRecord, BamWriter
    from ..io.slow5 import Slow5Writer
    from ..models.pore_model import PoreModelSet

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    genome = random_sequence(rng, genome_len)
    ref_fa = os.path.join(d, "ref.fa")
    _write_fasta(ref_fa, "tig1", genome)
    read = "".join(genome[a:b] for a, b in keep)
    fastq, slow5 = os.path.join(d, "reads.fastq"), os.path.join(d, "sig.slow5")
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        fq.write(f"@del1\n{read}\n+\n{'I' * len(read)}\n")
        pa = synthetic_raw_signal(rng, read, model,
                                  SquiggleScalings.from4(0.0, 1.0, 0.0, 1.0),
                                  samples_per_base=10.0, leader=500,
                                  trailer=100)
        sw.write("del1", _signal_adc(pa), 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    bam = os.path.join(d, "aln.bam")
    cigar = [(0, keep[0][1] - keep[0][0])]
    for (_, b0), (a1, b1) in zip(keep, keep[1:]):
        cigar += [(2, a1 - b0), (0, b1 - a1)]
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"], [genome_len])
    w.write(BamRecord(qname="del1", tid=0, pos=keep[0][0], mapq=60,
                      cigar=cigar, seq=read,
                      qual=np.full(len(read), 30, np.uint8)))
    w.close()
    return ref_fa, fastq, bam


def _write_plan_bam(path: str, genome: str, plan) -> None:
    """A coordinate-sorted BAM of full-length M records for plan =
    [(name, pos, is_rev, read_len)] on contig tig1."""
    from ..io.bam import BamRecord, BamWriter
    w = BamWriter(path, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"],
                  [len(genome)])
    for name, pos, is_rev, rlen in sorted(plan, key=lambda t: t[1]):
        w.write(BamRecord(qname=name, flag=16 if is_rev else 0, tid=0,
                          pos=pos, mapq=60, cigar=[(0, rlen)],
                          seq=genome[pos:pos + rlen],
                          qual=np.full(rlen, 30, np.uint8)))
    w.close()


# the long-read mix: N50 30 kb (the 30 kb reads carry over half the
# bases), longest 100 kb
LONGREAD_LENGTHS = (100_000, 30_000, 30_000, 30_000, 30_000)


def build_longread_corpus(d: str, read_lengths=LONGREAD_LENGTHS,
                          seed: int = 41, subset=()) -> dict:
    """Reference FASTA, basecalls, slow5 signal (9 samples a base), readdb
    index and BAM in directory d for reads lr0, lr1, ... of read_lengths,
    lr<i> at 5,000 x i on a random genome, every other one reverse.
    With ``subset`` (read names) a second BAM holds only those reads.
    Returns {ref_fa, fastq, bam, plan[, subset_bam]} with plan =
    [(name, pos, is_rev, read_len)]."""
    from ..apps import index as index_app
    from ..io.slow5 import Slow5Writer
    from ..models.pore_model import PoreModelSet
    from ..utils.alphabet import DNA_ALPHABET

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    genome = random_sequence(rng, max(read_lengths) + 5_000 * len(read_lengths))
    ref_fa = os.path.join(d, "ref.fa")
    _write_fasta(ref_fa, "tig1", genome)
    plan = [(f"lr{i}", 5_000 * i, bool(i % 2), rlen)
            for i, rlen in enumerate(read_lengths)]
    fastq, slow5 = os.path.join(d, "reads.fastq"), os.path.join(d, "sig.slow5")
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for name, pos, is_rev, rlen in plan:
            seg = genome[pos:pos + rlen]
            basecall = DNA_ALPHABET.reverse_complement(seg) if is_rev else seg
            fq.write(f"@{name}\n{basecall}\n+\n{'I' * rlen}\n")
            pa = synthetic_raw_signal(rng, basecall, model,
                                      SquiggleScalings.from4(0.0, 1.0, 0.0,
                                                             1.0),
                                      samples_per_base=9.0, leader=500,
                                      trailer=100)
            sw.write(name, _signal_adc(pa), 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    out = {"ref_fa": ref_fa, "fastq": fastq, "bam": os.path.join(d, "aln.bam"),
           "plan": plan}
    _write_plan_bam(out["bam"], genome, plan)
    if subset:
        out["subset_bam"] = os.path.join(d, "subset.bam")
        _write_plan_bam(out["subset_bam"], genome,
                        [p for p in plan if p[0] in subset])
    return out


SUBSTITUTE = {"A": "G", "C": "T", "G": "A", "T": "C"}


def build_scale_corpus(d: str, n_reads: int = 500, read_len: int = 1200,
                       genome_len: int = 50_000, var_win=(20_000, 22_000),
                       seed: int = 4242, subset=()) -> dict:
    """n_reads reads of read_len bases evenly staggered over a random
    genome_len truth (every third one reverse, every other one with signal
    drawn from the cpg model over its CpG-methylated basecall; 9 samples a
    base); the draft reference carries a substitution every 300 bases of
    var_win from 120 in.  Files in directory d; with ``subset`` (read
    names) a second BAM holds only those reads.  Returns {draft_fa,
    fastq, bam, draft, truth, subs, plan[, subset_bam]} with plan =
    [(name, pos, is_rev, read_len)]."""
    from ..apps import index as index_app
    from ..io.slow5 import Slow5Writer
    from ..models.pore_model import PoreModelSet
    from ..utils.alphabet import DNA_ALPHABET, METHYL_CPG_ALPHABET

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    pms = PoreModelSet.instance()
    nuc = pms.get_model("r9.4_450bps", "nucleotide", "template", 6)
    cpg = pms.get_model("r9.4_450bps", "cpg", "template", 6)
    truth = random_sequence(rng, genome_len)
    subs = list(range(var_win[0] + 120, var_win[1] - 120, 300))
    draft = list(truth)
    for p in subs:
        draft[p] = SUBSTITUTE[draft[p]]
    draft = "".join(draft)
    draft_fa = os.path.join(d, "draft.fa")
    _write_fasta(draft_fa, "tig1", draft)
    step = (genome_len - read_len - 200) // n_reads
    reads = [(f"s{i:04d}", 100 + step * i, bool(i % 3 == 1), bool(i % 2))
             for i in range(n_reads)]
    fastq, slow5 = os.path.join(d, "reads.fastq"), os.path.join(d, "sig.slow5")
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for name, pos, is_rev, is_meth in reads:
            seg = truth[pos:pos + read_len]
            basecall = DNA_ALPHABET.reverse_complement(seg) if is_rev else seg
            fq.write(f"@{name}\n{basecall}\n+\n{'I' * read_len}\n")
            sig_seq = (METHYL_CPG_ALPHABET.methylate(basecall)
                       if is_meth else basecall)
            pa = synthetic_raw_signal(rng, sig_seq, cpg if is_meth else nuc,
                                      SquiggleScalings.from4(0.0, 1.0, 0.0,
                                                             1.0),
                                      samples_per_base=9.0, leader=400,
                                      trailer=90)
            sw.write(name, _signal_adc(pa), 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    plan = [(name, pos, is_rev, read_len) for name, pos, is_rev, _ in reads]
    out = {"draft_fa": draft_fa, "fastq": fastq,
           "bam": os.path.join(d, "aln.bam"), "draft": draft, "truth": truth,
           "subs": subs, "plan": plan}
    # the reads are truth, so their BAM records carry the truth's bases
    _write_plan_bam(out["bam"], truth, plan)
    if subset:
        out["subset_bam"] = os.path.join(d, "subset.bam")
        _write_plan_bam(out["subset_bam"], truth,
                        [p for p in plan if p[0] in subset])
    return out
