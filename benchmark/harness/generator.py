"""The traffic generator: one cell's inputs from its configuration, its
traffic mix and a seed.

Frozen from the port's ``utils/synthetic.py`` (``random_sequence``,
``synthetic_raw_signal``, ``_signal_adc``, ``build_longread_corpus``) so
that a change to the program cannot change the benchmark's inputs.  What
it adds: a pass's reads as one region job at the configuration's
coverage, their lengths the stratified quantiles of the mix's log-normal
laid out along the region in one order for every seed (every seed does
the same work, down to how the apps' chunks of reads in coordinate order
pad; the seed places the reads, keeping that order, and draws genome,
strands, sequence and noise), a genome of a stated composition, and
per-site CpG methylation in the signal.

``synthesize`` makes everything in memory first (``Dataset``: the genome,
each read's placement, basecall and raw ADC samples), then ``write_files``
writes the files the apps read (FASTA, FASTQ, BLOW5, BAM) with the port's
writers and runs the port's ``index`` once, as users do once per dataset.
The plain reference takes the in-memory ``Dataset``; it never reads what
the port wrote.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np

from reference.common import CPG, NUC, PoreModel, kmer_ranks, revcomp

# ADC of the synthetic signal (the port's utils/synthetic._signal_adc)
DIGITISATION = 8192.0
ADC_RANGE = 1400.0
ADC_OFFSET = 0.0
SAMPLE_RATE = 4000.0
LEADER, TRAILER = 500, 100          # low-variance stalls trimming removes


def reads_per_pass(cfg: dict, traffic: dict) -> int:
    """Reads of one pass: the configuration's coverage of its genome (one
    region job) over the mix's mean read length, exp(mu + sigma^2 / 2)."""
    mean = float(traffic["median_bases"]) * np.exp(
        float(traffic["sigma"]) ** 2 / 2.0)
    return max(1, int(round(float(cfg["coverage"]) *
                            float(cfg["genome"]["length"]) / mean)))


# the order of a pass's lengths along its region, the same for every seed:
# an app takes reads in coordinate order, in chunks padded to their
# longest, so an order the seed shuffled would change the padded work
LAYOUT_KEY = [0, 1]


def read_lengths(traffic: dict, n: int) -> np.ndarray:
    """n read lengths of the mix: the (i + 0.5) / n quantiles of a
    log-normal of the given median and sigma, clipped and rounded, in
    one shuffled order, the reads' order along the region."""
    nd = NormalDist()
    mu = np.log(float(traffic["median_bases"]))
    q = [nd.inv_cdf((i + 0.5) / n) for i in range(n)]
    lens = np.exp(mu + float(traffic["sigma"]) * np.asarray(q))
    lens = np.clip(np.rint(lens), traffic["min_bases"], traffic["max_bases"])
    lens = lens.astype(np.int64)
    np.random.default_rng(LAYOUT_KEY).shuffle(lens)
    return lens


def make_genome(rng: np.random.Generator, cfg: dict) -> str:
    """A random genome of cfg's GC share; where cfg caps the CpG share of
    dinucleotides, CpGs are first drawn at the i.i.d. rate of a richer GC
    share and most are then turned into TpG, as deamination does, so that
    both figures come out near the stated ones."""
    g = cfg["genome"]
    n = int(g["length"])
    gc = float(g["gc"])
    cpg = g.get("cpg_per_dinucleotide")
    if cpg is None:
        gc0, keep = gc, 1.0
    else:
        # gc0 - (gc0 / 2)^2 (1 - keep) = gc and (gc0 / 2)^2 keep = cpg
        b = gc - cpg
        gc0 = (4.0 - np.sqrt(16.0 - 16.0 * b)) / 2.0
        keep = cpg / (gc0 / 2.0) ** 2
    p = np.array([(1 - gc0) / 2, gc0 / 2, gc0 / 2, (1 - gc0) / 2])
    codes = rng.choice(4, size=n, p=p).astype(np.uint8)
    if keep < 1.0:
        cg = np.flatnonzero((codes[:-1] == 1) & (codes[1:] == 2))
        drop = cg[rng.random(len(cg)) >= keep]
        codes[drop] = 3                                  # C -> T
    return np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode("ascii")


def raw_signal(rng, level: np.ndarray, stdv: np.ndarray,
               samples_per_base: float) -> np.ndarray:
    """Kmer levels -> pA samples: a Poisson dwell (at least 3 samples) a
    kmer, Gaussian noise of the kmer's stdv, and the stalls around it
    (the port's synthetic_raw_signal with scalings 0, 1, 0, 1)."""
    nsamp = np.maximum(3, rng.poisson(samples_per_base, size=len(level)))
    sig = rng.normal(np.repeat(level, nsamp), np.repeat(stdv, nsamp))
    return np.concatenate([rng.normal(100.0, 0.05, size=LEADER), sig,
                           rng.normal(100.0, 0.05, size=TRAILER)]
                          ).astype(np.float32)


def signal_adc(pa: np.ndarray) -> np.ndarray:
    return np.clip(pa * DIGITISATION / ADC_RANGE, -32000, 32000
                   ).astype(np.int16)


@dataclass
class Read:
    name: str
    pos: int                 # 0-based leftmost on the genome
    rc: bool                 # basecall is the reverse complement
    basecall: str
    adc: np.ndarray          # int16 raw samples
    bam_index: int = -1      # order in the coordinate-sorted BAM


@dataclass
class Dataset:
    contig: str
    genome: str
    reads: List[Read]
    models_npz: str

    @property
    def bases(self) -> int:
        return int(sum(len(r.basecall) for r in self.reads))


def synthesize(cfg: dict, traffic: dict, seed: int, models_npz: str
               ) -> Dataset:
    """The cell's reads in memory: how many from the configuration's
    coverage, their lengths and their order along the genome from the
    mix; placements (sorted, so that the order holds), strands (exactly
    half reverse) and signal from the seed."""
    rng = np.random.default_rng([seed, 0])
    genome = make_genome(rng, cfg)
    lens = read_lengths(traffic, reads_per_pass(cfg, traffic))
    n = len(lens)
    # every read fits whatever its place in the order
    starts = np.sort(rng.integers(0, len(genome) - int(lens.max()), size=n))
    rev = np.zeros(n, bool)
    rev[: n // 2] = True
    rng.shuffle(rev)
    sig = cfg["signal"]
    k = int(sig["k"])
    nuc = PoreModel(models_npz, sig["model"], NUC, k)
    meth = sig.get("methylated_model")
    if meth:
        cpg = PoreModel(models_npz, meth, CPG, k)
        p_meth = float(sig["p_methylated"])
    spb = float(sig["samples_per_base"])
    reads = []
    for i, L in enumerate(lens.tolist()):
        pos = int(starts[i])
        seg = genome[pos:pos + L]
        bc = revcomp(seg) if rev[i] else seg
        ranks = kmer_ranks(bc, NUC, k)
        level, stdv = nuc.level_mean[ranks], nuc.level_stdv[ranks]
        if meth:
            # each CpG of this read is methylated with p_meth; a kmer that
            # holds a methylated C takes the cpg model's level
            sites = np.array([j for j in _find_all(bc, "CG")], np.int64)
            chosen = sites[rng.random(len(sites)) < p_meth]
            mseq = bytearray(bc.encode("ascii"))
            for j in chosen.tolist():
                mseq[j] = ord("M")
            mseq = mseq.decode("ascii")
            mr = kmer_ranks(mseq, CPG, k)
            has_m = np.zeros(len(bc) + 1, np.int64)
            has_m[chosen + 1] = 1
            cm = np.cumsum(has_m)
            in_kmer = (cm[k:k + len(ranks)] - cm[:len(ranks)]) > 0
            level = np.where(in_kmer, cpg.level_mean[mr], level)
            stdv = np.where(in_kmer, cpg.level_stdv[mr], stdv)
        adc = signal_adc(raw_signal(rng, level, stdv, spb))
        reads.append(Read(name=f"read{i:05d}", pos=pos, rc=bool(rev[i]),
                          basecall=bc, adc=adc))
    for j, r in enumerate(sorted(reads, key=lambda r: (r.pos, r.name))):
        r.bam_index = j
    return Dataset(contig=cfg["genome"]["contig"], genome=genome,
                   reads=reads, models_npz=models_npz)


def _find_all(s: str, pat: str):
    i = s.find(pat)
    while i != -1:
        yield i
        i = s.find(pat, i + 1)


def write_files(ds: Dataset, d: str) -> dict:
    """FASTA, FASTQ, BLOW5, the readdb index and the BAM in d."""
    from nanopolish_tpu_torch.apps import index as index_app
    from nanopolish_tpu_torch.io.bam import BamRecord, BamWriter
    from nanopolish_tpu_torch.io.slow5 import Blow5Writer

    os.makedirs(d, exist_ok=True)
    ref_fa = os.path.join(d, "ref.fa")
    with open(ref_fa, "w") as fh:
        fh.write(f">{ds.contig}\n")
        g = ds.genome
        fh.write("\n".join(g[i:i + 60] for i in range(0, len(g), 60)))
        fh.write("\n")
    fastq = os.path.join(d, "reads.fastq")
    blow5 = os.path.join(d, "signal.blow5")
    with open(fastq, "w") as fq, Blow5Writer(blow5) as bw:
        for r in ds.reads:
            fq.write(f"@{r.name}\n{r.basecall}\n+\n{'I' * len(r.basecall)}\n")
            bw.write(r.name, r.adc, DIGITISATION, ADC_OFFSET, ADC_RANGE,
                     SAMPLE_RATE)
    index_app.main([fastq, "--slow5", blow5])
    bam = os.path.join(d, "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", [ds.contig],
                  [len(ds.genome)])
    for r in sorted(ds.reads, key=lambda r: (r.pos, r.name)):
        L = len(r.basecall)
        w.write(BamRecord(qname=r.name, flag=16 if r.rc else 0, tid=0,
                          pos=r.pos, mapq=60, cigar=[(0, L)],
                          seq=ds.genome[r.pos:r.pos + L],
                          qual=np.full(L, 30, np.uint8)))
    w.close()
    return {"ref_fa": ref_fa, "fastq": fastq, "bam": bam}
