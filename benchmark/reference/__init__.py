"""The plain reference: nanopolish's eventalign and call-methylation worked
out again from a cell's raw inputs (the reads' basecalls, placements and
ADC samples, the genome, the raw pore-model file), in NumPy and plain
PyTorch.  It imports nothing of the program and takes nothing the program
made; eventalign's chain may be handed the program's printed rows as
guesses that batch its Viterbi, and its rows are the same without them
(see ``eventalign``).

``rows(...)`` is the entry: for each read given, the rows the app prints
(the text line and the exact number the line rounds: eventalign's scaled
event level, call-methylation's log-likelihood ratio).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import eventalign, ingest, methylation
from .common import CPG, F32, NUC, PoreModel, Precision, kmer_ranks

NUC_MODEL = "r9_4_450bps_nucleotide_6mer_template"
CPG_MODEL = "r9_4_450bps_cpg_6mer_template"


def ingest_reads(reads: List[dict], adc: dict, max_read_length: int,
                 models_npz: str, prec: Precision = F32) -> Dict[str, object]:
    """Events and ingest of each read.  The padded widths of the
    program's ingest batch follow from the longest read, which the caller
    includes in ``reads``."""
    nuc = PoreModel(models_npz, NUC_MODEL, NUC, 6)
    evs = {r["name"]: ingest.detect_read(r["adc"], adc["offset"],
                                         adc["range"], adc["digitisation"],
                                         adc["sample_rate"])
           for r in reads}
    T = ingest.bucket(max(len(e.mean) for e in evs.values() if e))
    K = ingest.bucket(max_read_length - 6 + 1)
    out = {}
    for r in reads:
        e = evs[r["name"]]
        if e is None:
            out[r["name"]] = None
            continue
        ranks = kmer_ranks(r["basecall"], NUC, 6)
        out[r["name"]] = ingest.ingest(r["name"], e, ranks, nuc.level_mean,
                                       nuc.level_stdv, T, K, prec)
    return out


def rows(app: str, reads: List[dict], genome: str, contig: str,
         adc: dict, max_read_length: int, models_npz: str, device,
         guesses: Optional[dict] = None, prec: Precision = F32
         ) -> Dict[str, list]:
    """name -> [(line, exact value)] for each read, as ``app`` prints them.
    ``guesses`` (eventalign): name -> (ref position, event) rows whose
    every 50th is tried as a segment hand-off."""
    ing = ingest_reads(reads, adc, max_read_length, models_npz, prec)
    if app == "eventalign":
        nuc = PoreModel(models_npz, NUC_MODEL, NUC, 6)
        jobs = []
        for r in reads:
            rd = ing[r["name"]]
            job = None if rd is None else eventalign.make_job(
                rd, r["name"], r["bam_index"], r["rc"], r["pos"],
                len(r["basecall"]), genome, nuc.level_mean, nuc.level_stdv)
            if job is not None:
                jobs.append(job)
        eventalign.align(jobs, guesses or {}, device, prec)
        out = {r["name"]: [] for r in reads}
        for job in jobs:
            out[job.name] = eventalign.render(job, contig, nuc.level_mean,
                                              nuc.level_stdv)
        return out
    if app == "call-methylation":
        cpg = PoreModel(models_npz, CPG_MODEL, CPG, 6)
        per = {}
        for r in reads:
            rd = ing[r["name"]]
            per[r["name"]] = [] if rd is None else methylation.groups(
                rd, r["rc"], r["pos"], len(r["basecall"]), genome,
                cpg.level_mean, cpg.level_stdv)
        scored = methylation.score(per, device, prec)
        return {r["name"]: methylation.render(scored[r["name"]], contig,
                                              r["name"], r["rc"])
                for r in reads}
    raise ValueError(f"no reference for app {app!r}")
