"""`vcf2fasta` subcommand: merge per-window consensus VCFs into a polished
fasta.

Rebuild of vcf2fasta_main (reference: src/nanopolish_vcf2fasta.cpp:127-299):
window tiling checks from ##nanopolish_window headers, variant dedup, and
application via a tagged consensus array.  Host only: it touches no
device.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, TextIO, Tuple

from ..io.fasta import FastaIndex
from ..io.vcf import Variant, VcfReader


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nanopolish_tpu_torch vcf2fasta",
                                description="write a new genome using variants in vcf files")
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("--skip-checks", action="store_true")
    p.add_argument("vcfs", nargs="+")
    return p


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    out = stdout if stdout is not None else sys.stdout

    fai = FastaIndex(opt.genome)
    variants_by_contig: Dict[str, List[Variant]] = {}
    windows_by_contig: Dict[str, List[Tuple[int, int]]] = {}

    for filename in opt.vcfs:
        reader = VcfReader(filename)
        window = reader.window()
        if window is None:
            print(f"error: could not detect polishing window from input "
                  f"file {filename}", file=sys.stderr)
            raise SystemExit(1)
        ctg, ws, we = window
        windows_by_contig.setdefault(ctg, []).append((ws, we))
        for v in reader:
            variants_by_contig.setdefault(v.ref_name, []).append(v)

    for contig in fai.names():
        contig_length = fai.length(contig)
        windows = sorted(windows_by_contig.get(contig, []))
        ok = True
        if not opt.skip_checks:
            if not windows:
                print(f"error: no polishing windows found for {contig}",
                      file=sys.stderr)
                raise SystemExit(1)
            for i in range(1, len(windows)):
                ps, pe = windows[i - 1]
                cs, ce = windows[i]
                if cs > pe:
                    print(f"error: adjacent polishing windows do not overlap "
                          f"({ps}-{pe} and {cs}-{ce})", file=sys.stderr)
                    ok = False
            if windows[0][0] != 0:
                print(f"error: first {windows[0][0]} bases are not covered "
                      f"by a polished window for contig {contig}.",
                      file=sys.stderr)
                ok = False
            end_gap = contig_length - windows[-1][1]
            if end_gap > 500:
                print(f"error: last {end_gap} bases are not covered by a "
                      f"polished window for contig {contig}.",
                      file=sys.stderr)
                ok = False
        if not ok:
            print("error: one or more polishing windows are missing. Please "
                  "check that all nanopolish variants --consensus jobs ran "
                  "to completion", file=sys.stderr)
            raise SystemExit(1)

        seq = fai.fetch(contig).upper()
        variants = sorted(variants_by_contig.get(contig, []),
                          key=lambda v: v.ref_position)
        seen = set()
        deduped = []
        for v in variants:
            if v.key() not in seen:
                seen.add(v.key())
                deduped.append(v)
        variants = deduped

        # tagged consensus array: None = deleted, int = variant index,
        # str = literal base
        consensus: List = list(seq)
        num_skipped = num_subs = num_ins = num_dels = 0
        for vi, v in enumerate(variants):
            ref = v.ref_seq
            window = consensus[v.ref_position:v.ref_position + len(ref)]
            matches = len(window) == len(ref) and \
                all(isinstance(c, str) and c == r
                    for c, r in zip(window, ref))
            if not matches:
                num_skipped += 1
                continue
            consensus[v.ref_position] = vi
            for i in range(1, len(ref)):
                consensus[v.ref_position + i] = None
            num_subs += len(v.ref_seq) == len(v.alt_seq)
            num_ins += len(v.ref_seq) < len(v.alt_seq)
            num_dels += len(v.ref_seq) > len(v.alt_seq)

        parts = []
        for c in consensus:
            if c is None:
                continue
            if isinstance(c, int):
                parts.append(variants[c].alt_seq)
            else:
                parts.append(c)
        print(f"[vcf2fasta] rewrote contig {contig} with {num_subs} subs, "
              f"{num_ins} ins, {num_dels} dels ({num_skipped} skipped)",
              file=sys.stderr)
        out.write(f">{contig}\n{''.join(parts)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
