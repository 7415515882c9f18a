"""`index` subcommand: build the ReadDB linking basecalled reads to signal.

Rebuild of index_main (reference: src/nanopolish_index.cpp:343-413):
fastq -> bgzipped fasta + faidx; signal located from -d dirs, -f fofn,
-s sequencing_summary.txt, or --slow5.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..io.readdb import (ReadDB, find_signal_files, index_signal_files,
                         parse_sequencing_summary)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nanopolish_tpu_torch index",
                                description="build an index mapping reads to signal data")
    p.add_argument("reads", help="basecalled reads (fasta/fastq)")
    p.add_argument("-d", "--directory", action="append", default=[],
                   help="path to directory of fast5/slow5 files")
    p.add_argument("-f", "--fast5-fofn", default="",
                   help="file containing paths to fast5 files")
    p.add_argument("-s", "--sequencing-summary", action="append", default=[],
                   help="sequencing summary file from albacore/guppy")
    p.add_argument("--slow5", default="",
                   help="slow5/blow5 file containing the raw signal")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv: Optional[List[str]] = None):
    opt = make_parser().parse_args(argv)
    db = ReadDB()
    db.build(opt.reads)

    if opt.slow5:
        db.set_slow5_mode(opt.slow5)
    else:
        summary_map = {}
        for s in opt.sequencing_summary:
            summary_map.update(parse_sequencing_summary(s))
        paths: List[str] = []
        if opt.fast5_fofn:
            with open(opt.fast5_fofn) as fh:
                paths += [l.strip() for l in fh if l.strip()]
        for d in opt.directory:
            paths += find_signal_files([d])
        if summary_map and opt.directory:
            # resolve summary filenames against the provided directories
            by_base = {os.path.basename(p): p for p in paths}
            resolved = {rid: by_base[fn] for rid, fn in summary_map.items()
                        if fn in by_base}
            db.import_signal_map(resolved)
            unresolved = [p for p in paths
                          if os.path.basename(p) not in
                          {os.path.basename(v) for v in resolved.values()}]
            index_signal_files(db, unresolved)
        else:
            index_signal_files(db, paths)
    db.save()
    with_path = sum(1 for n in db.get_all_read_names()
                    if db.get_signal_path(n))
    print(f"[readdb] num reads: {db.get_num_reads()}, num reads with path "
          f"to signal file: {with_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
