"""`eventalign` subcommand: align nanopore events to the reference genome.

Rebuild of eventalign_main / realign_read / emit_*
(reference: src/alignment/nanopolish_eventalign.cpp:901-959, :539-610,
:398-536) with reference-exact TSV, summary and SAM formats.  Read ingest
and the HMM work run batched on the card (``--device cuda``, the default)
or, when asked, on the CPU (``--device cpu``) via the segment wavefront
(alignment/eventalign.align_reads_to_ref).
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import List, Optional, TextIO

import numpy as np

from ..alignment.eventalign import EventAlignment, align_reads_to_ref
from ..io.bam import BamRecord
from ..io.fasta import FastaIndex
from ..io.readdb import ReadDB
from ..models.read_builder import GLOBAL_READ_STATS, SRF_LOAD_RAW_SAMPLES
from ..models.read_loader import load_squiggle_reads
from ..models.squiggle import SquiggleRead
from ..utils.device import resolve_device
from ..utils.profiler import profile_scope
from .bam_processor import BamBatchProcessor


def emit_tsv_header(fp: TextIO, print_read_names: bool,
                    write_signal_index: bool, write_samples: bool):
    """eventalign.cpp:227-242."""
    fp.write("contig\tposition\treference_kmer\t"
             + ("read_name" if print_read_names else "read_index")
             + "\tstrand\t")
    fp.write("event_index\tevent_level_mean\tevent_stdv\tevent_length\t")
    fp.write("model_kmer\tmodel_mean\tmodel_stdv\tstandardized_level")
    if write_signal_index:
        fp.write("\tstart_idx\tend_idx")
    if write_samples:
        fp.write("\tsamples")
    fp.write("\n")


_KMER_RANK_CACHE: dict = {}


def emit_event_alignment_tsv_cols(fp: TextIO, sr: SquiggleRead,
                                  strand_idx: int, cols,
                                  print_read_names: bool, scale_events: bool,
                                  write_signal_index: bool,
                                  write_samples: bool):
    """eventalign.cpp:398-484 with identical printf formats, rendered
    straight from EventAlignmentColumns arrays (no per-row objects).  Kmer ranks come
    from one whole-window seq_to_kmer_ranks pass (for rc rows,
    rank(revcomp(seq[i:i+k])) == ranks(revcomp(seq))[n-k-i]); numeric
    columns use the identical f32 expressions; byte-equality with the
    row path is pinned by tests/test_eventalign_e2e.py and the frozen
    goldens."""
    n = len(cols)
    if n == 0:
        return
    model = sr.base_model[strand_idx]
    k = model.k
    alphabet = model.alphabet
    scalings = sr.scalings[strand_idx]
    sqrt_var = math.sqrt(scalings.var)

    seq = cols.ref_seq
    off = cols.ref_offset
    nseq = len(seq)
    rc = cols.rc
    pos0 = cols.ref_position - off
    is_b = cols.state == 66                      # 'B'
    ev_idx = cols.event_idx
    if rc:
        rcq = alphabet.reverse_complement(seq)
        wranks = alphabet.seq_to_kmer_ranks(rcq, k)
        ranks = wranks[np.minimum(nseq - k - pos0, len(wranks) - 1)]
    else:
        rcq = ""
        wranks = alphabet.seq_to_kmer_ranks(seq, k)
        ranks = wranks[np.minimum(pos0, len(wranks) - 1)]
    ranks = np.where(is_b, 0, ranks)

    event_stdv_col = sr.get_stdv(ev_idx, strand_idx)
    event_dur_col = sr.get_duration(ev_idx, strand_idx)
    if scale_events:
        event_mean_col = sr.get_fully_scaled_level(ev_idx, strand_idx)
        mm32 = model.level_mean[ranks].astype(np.float32)
        ms32 = model.level_stdv[ranks].astype(np.float32)
    else:
        event_mean_col = sr.get_unscaled_level(ev_idx, strand_idx)
        mm, ms = sr.get_scaled_gaussian(model, strand_idx, ranks)
        mm32 = np.asarray(mm, np.float32)
        ms32 = np.asarray(ms, np.float32)
    model_mean_col = np.where(is_b, np.float32(0), mm32)
    model_stdv_col = np.where(is_b, np.float32(0), ms32)
    den32 = (np.float64(sqrt_var) *
             model_stdv_col.astype(np.float64)).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        std_col = np.where(
            model_stdv_col > 0,
            (event_mean_col - model_mean_col) / den32,
            np.where(event_mean_col > model_mean_col, np.float32(np.inf),
                     np.where(event_mean_col < model_mean_col,
                              np.float32(-np.inf), np.float32(np.nan))))

    who = sr.read_name if print_read_names else str(cols.read_idx)
    strand_ch = "tc"[cols.strand_idx]
    ref_name = cols.ref_name
    nk_str = "N" * k
    extra = write_signal_index or write_samples
    if not extra:
        # native row formatter (csrc/tsv_format.cpp): ~0.2 us/row vs
        # ~3 us for the f-string loop; byte-identical output
        from ..utils.native import get_native_lib
        lib = get_native_lib()
        if lib is not None:
            res = lib.format_eventalign_rows(
                ref_name, who, strand_ch, seq, rcq, rc, k,
                cols.ref_position, pos0, ev_idx, is_b,
                event_mean_col, event_stdv_col, event_dur_col,
                model_mean_col, model_stdv_col, std_col)
            if res is not None:
                fp.write(res)
                return
    rp_l = cols.ref_position.tolist()
    p_l = pos0.tolist()
    ev_l = ev_idx.tolist()
    b_l = is_b.tolist()
    em_l = event_mean_col.tolist()
    es_l = event_stdv_col.tolist()
    ed_l = event_dur_col.tolist()
    mm_l = model_mean_col.tolist()
    ms_l = model_stdv_col.tolist()
    sd_l = std_col.tolist()
    lines = []
    ap = lines.append
    for i in range(n):
        p = p_l[i]
        ref_kmer = seq[p:p + k]
        model_kmer = nk_str if b_l[i] else (
            rcq[nseq - p - k:nseq - p] if rc else ref_kmer)
        row = (f"{ref_name}\t{rp_l[i]}\t{ref_kmer}\t{who}\t{strand_ch}\t"
               f"{ev_l[i]}\t{em_l[i]:.2f}\t{es_l[i]:.3f}\t{ed_l[i]:.5f}\t"
               f"{model_kmer}\t{mm_l[i]:.2f}\t{ms_l[i]:.2f}\t{sd_l[i]:.2f}")
        if extra:
            if write_signal_index:
                s, e = sr.get_event_sample_idx(cols.strand_idx, ev_l[i])
                row += f"\t{s}\t{e}"
            if write_samples:
                samples = sr.get_scaled_samples_for_event(
                    cols.strand_idx, ev_l[i])
                row += "\t" + ",".join(f"{v:g}" for v in samples)
        ap(row)
    fp.write("\n".join(lines) + "\n")


class EventalignSummary:
    """eventalign.cpp:128-153 + summarize_alignment (:486-536)."""

    def __init__(self):
        self.num_events = 0
        self.num_steps = 0
        self.num_stays = 0
        self.num_skips = 0
        self.sum_duration = 0.0
        self.sum_z_score = 0.0
        self.alignment_edit_distance = 0
        self.reference_span = 0


def summarize_alignment(sr: SquiggleRead, strand_idx: int,
                        alignments: List[EventAlignment],
                        record: BamRecord) -> EventalignSummary:
    s = EventalignSummary()
    model = sr.base_model[strand_idx]
    k = model.k
    scalings = sr.scalings[strand_idx]
    rank_cache = _KMER_RANK_CACHE.setdefault(
        (model.alphabet.name, model.alphabet.bases, k), {})
    prev_ref_pos = None
    for i, ea in enumerate(alignments):
        s.num_events += 1
        ref_move = None if prev_ref_pos is None else ea.ref_position - prev_ref_pos
        if ref_move == 0:
            s.num_stays += 1
        elif i != 0 and ref_move is not None and ref_move > 1:
            s.num_skips += 1
        elif i != 0 and ref_move == 1:
            s.num_steps += 1
        s.sum_duration += float(sr.get_duration(ea.event_idx, ea.strand_idx))
        if ea.hmm_state == "M":
            rank = rank_cache.get(ea.model_kmer)
            if rank is None:
                rank = model.alphabet.kmer_rank(ea.model_kmer, k)
                rank_cache[ea.model_kmer] = rank
            mu, sd = sr.get_scaled_gaussian(model, ea.strand_idx, rank)
            level = sr.get_drift_scaled_level(ea.event_idx, ea.strand_idx)
            s.sum_z_score += (float(level) - float(mu)) / float(sd)
        prev_ref_pos = ea.ref_position
    nm = record.tags.get("NM")
    s.alignment_edit_distance = int(nm[1]) if nm else 0
    if alignments:
        s.reference_span = alignments[-1].ref_position - \
            alignments[0].ref_position + 1
    return s


# ---- SAM output (eventalign.cpp:254-396) ----------------------------------

def event_alignment_to_cigar(alignments: List[EventAlignment]) -> List:
    out = []
    if alignments[0].event_idx > 0:
        out.append((4, alignments[0].event_idx))      # soft clip
    out.append((0, 1))                                # always start with M
    prev_r = alignments[0].ref_position
    prev_e = alignments[0].event_idx
    for ea in alignments[1:]:
        r_step = abs(ea.ref_position - prev_r)
        e_step = abs(ea.event_idx - prev_e)
        if r_step == 1 and e_step == 1:
            incoming = (0, 1)
        elif r_step > 1:
            assert e_step == 1
            out.append((2, r_step - 1))               # D
            incoming = (0, 1)
        else:
            assert e_step == 1 and r_step == 0
            incoming = (1, 1)                         # I
        if out[-1][0] == incoming[0]:
            out[-1] = (incoming[0], out[-1][1] + incoming[1])
        else:
            out.append(incoming)
        prev_r = ea.ref_position
        prev_e = ea.event_idx
    return out


def emit_event_alignment_sam(fp: TextIO, sr: SquiggleRead,
                             record: BamRecord, references: List[str],
                             alignments: List[EventAlignment]):
    if not alignments:
        return
    first = alignments[0]
    ea_cigar = event_alignment_to_cigar(alignments)
    out = BamRecord(
        qname=sr.read_name,
        flag=16 if first.rc else 0,
        tid=record.tid,
        pos=first.ref_position,
        mapq=record.mapq,
        cigar=ea_cigar,
        seq="",
        qual=None,
        tags={"ES": ("i", 1 if alignments[-1].event_idx >= first.event_idx
                     else -1)},
    )
    fp.write(out.to_sam(references) + "\n")


def emit_sam_header(fp: TextIO, header_text: str, references: List[str],
                    lengths: List[int]):
    if header_text and not header_text.endswith("\n"):
        header_text += "\n"
    has_sq = "@SQ" in header_text
    fp.write(header_text)
    if not has_sq:
        for name, ln in zip(references, lengths):
            fp.write(f"@SQ\tSN:{name}\tLN:{ln}\n")


# ---- main -----------------------------------------------------------------

def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nanopolish_tpu_torch eventalign",
        description="align nanopore events to reference k-mers")
    p.add_argument("-r", "--reads", required=True)
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-w", "--window", default="")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-q", "--min-mapping-quality", type=int, default=0)
    p.add_argument("--sam", action="store_true")
    p.add_argument("--scale-events", action="store_true")
    p.add_argument("--print-read-names", action="store_true")
    p.add_argument("--signal-index", action="store_true")
    p.add_argument("--samples", action="store_true")
    p.add_argument("--summary", default="")
    p.add_argument("--models-fofn", default="")
    p.add_argument("--batchsize", type=int, default=512)
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("--shard", default="0/1",
                   help="process shard as index/total (e.g. 2/8)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where ingest and the HMM run (default: cuda; "
                        "there is no automatic fallback to the cpu)")
    return p


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    out = stdout if stdout is not None else sys.stdout
    device = resolve_device(opt.device)
    with profile_scope("ea.pass"):
        return _eventalign(opt, out, device)


def _eventalign(opt, out, device):
    if opt.models_fofn:
        from ..models.pore_model import PoreModelSet
        PoreModelSet.instance().initialize(opt.models_fofn)

    read_db = ReadDB()
    read_db.load(opt.reads)
    fai = FastaIndex(opt.genome)

    shard_index, shard_total = (int(x) for x in opt.shard.split("/"))
    proc = BamBatchProcessor(opt.bam, region=opt.window,
                             batch_size=opt.batchsize,
                             min_mapping_quality=opt.min_mapping_quality,
                             max_reads=opt.max_reads,
                             shard_index=shard_index,
                             shard_total=shard_total)
    summary_fp = open(opt.summary, "w") if opt.summary else None
    if summary_fp:
        summary_fp.write(
            "read_index\tread_name\tfast5_path\tmodel_name\tstrand\t"
            "num_events\tnum_steps\tnum_skips\tnum_stays\ttotal_duration\t"
            "shift\tscale\tdrift\tvar\n")

    if opt.sam:
        emit_sam_header(out, proc.header_text, proc.references,
                        proc.reader.lengths)
    else:
        emit_tsv_header(out, opt.print_read_names, opt.signal_index,
                        opt.samples)

    flags = SRF_LOAD_RAW_SAMPLES if (opt.samples or opt.signal_index) else 0
    region_start = proc.clip_start if opt.window else -1
    region_end = (proc.clip_end - 1) if (opt.window and proc.clip_end >= 0) \
        else -1

    batches = proc.batches()
    while True:
        with profile_scope("ea.next_batch"):
            batch = next(batches, None)
        if batch is None:
            break
        names = sorted({rec.qname for _, rec in batch})
        with profile_scope("ea.load_reads"):
            reads = load_squiggle_reads(names, read_db, flags=flags,
                                        stats=GLOBAL_READ_STATS,
                                        num_threads=opt.threads,
                                        device=device)
        jobs = []
        meta = []
        for read_idx, rec in batch:
            sr = reads.get(rec.qname)
            if sr is None:
                continue
            for strand in (0, 1):
                if not sr.has_events_for_strand(strand):
                    continue
                jobs.append((sr, rec, strand, read_idx))
                meta.append((sr, rec, strand, read_idx))
        with profile_scope("ea.align"):
            results = align_reads_to_ref(jobs, fai, proc.references,
                                         region_start, region_end,
                                         columnar=True, device=device)
        with profile_scope("ea.emit"):
            for (sr, rec, strand, read_idx), cols in zip(meta, results):
                alignment = None      # row materialization, on demand only
                if opt.sam:
                    alignment = cols.to_rows() if cols is not None else []
                    emit_event_alignment_sam(out, sr, rec, proc.references,
                                             alignment)
                elif cols is not None:
                    emit_event_alignment_tsv_cols(
                        out, sr, strand, cols, opt.print_read_names,
                        opt.scale_events, opt.signal_index, opt.samples)
                if summary_fp is not None and cols is not None and len(cols):
                    if alignment is None:
                        alignment = cols.to_rows()
                    s = summarize_alignment(sr, strand, alignment, rec)
                    sc = sr.scalings[strand]
                    model = sr.base_model[strand]
                    summary_fp.write(
                        f"{read_idx}\t{sr.read_name}\t{sr.fast5_path}\t"
                        f"{model.name}\t"
                        f"{'template' if strand == 0 else 'complement'}\t"
                        f"{s.num_events}\t{s.num_steps}\t{s.num_skips}\t"
                        f"{s.num_stays}\t{s.sum_duration:.2f}\t{sc.shift:.3f}\t"
                        f"{sc.scale:.3f}\t{sc.drift:.3f}\t{sc.var:.3f}\n")

    if summary_fp:
        summary_fp.close()
    proc.close()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
