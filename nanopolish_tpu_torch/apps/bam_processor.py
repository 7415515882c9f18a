"""Batched BAM iteration — the host-side data loader.

Rebuild of BamProcessor::parallel_run
(reference: src/common/nanopolish_bam_processor.cpp:49-133): stream the BAM
(optionally a region), buffer `batch_size` records, hand each batch to a
batch worker, preserving record order for output.  The reference's
`omp parallel for` over records becomes device batching inside the worker
(reads of a batch are aligned/scored together on the TPU).
"""

from __future__ import annotations

import re
import sys
from typing import Callable, Iterator, List, Optional, Tuple

from ..io.bam import BamReader, BamRecord

DEFAULT_BATCH_SIZE = 512


def parse_region(region: str) -> Tuple[str, int, int]:
    """'ctg', 'ctg:start-end' (1-based inclusive in text, half-open out).
    Returns (contig, start0, end) with -1 for unbounded."""
    m = re.match(r"^(.+?)(?::([\d,]+)-([\d,]+))?$", region)
    if not m:
        raise ValueError(f"cannot parse region {region!r}")
    ctg = m.group(1)
    if m.group(2) is None:
        return ctg, -1, -1
    start = int(m.group(2).replace(",", "")) - 1
    end = int(m.group(3).replace(",", ""))
    return ctg, start, end


class BamBatchProcessor:
    def __init__(self, bam_path: str, region: str = "",
                 batch_size: int = DEFAULT_BATCH_SIZE,
                 min_mapping_quality: int = 0,
                 max_reads: Optional[int] = None,
                 shard_index: int = 0, shard_total: int = 1):
        self.reader = BamReader(bam_path)
        self.region = region
        self.batch_size = batch_size
        self.min_mapping_quality = min_mapping_quality
        self.max_reads = max_reads
        # process-level sharding by record index (the reference's
        # file-suffix-mod-N watch-mode pattern, call_methylation.cpp:489-508,
        # generalized to any run)
        self.shard_index = shard_index
        self.shard_total = shard_total
        self.clip_start = -1
        self.clip_end = -1
        if region:
            ctg, s, e = parse_region(region)
            self.contig = ctg
            self.clip_start = s
            self.clip_end = e
        else:
            self.contig = None

    @property
    def references(self) -> List[str]:
        return self.reader.references

    @property
    def header_text(self) -> str:
        return self.reader.header_text

    def _records(self) -> Iterator[BamRecord]:
        if self.contig is not None:
            s = self.clip_start if self.clip_start >= 0 else 0
            e = self.clip_end if self.clip_end >= 0 else None
            if self.region and self.clip_start >= 0:
                print(f"[bam process] iterating over region: {self.region}",
                      file=sys.stderr)
            yield from self.reader.fetch(self.contig, s, e)
        else:
            yield from self.reader

    def batches(self) -> Iterator[List[Tuple[int, BamRecord]]]:
        """Yield batches of (read_idx, record); read_idx counts ALL
        streamed records (matching the reference's read_idx), while
        filtered records (unmapped / low mapq) are dropped from the batch."""
        buf: List[Tuple[int, BamRecord]] = []
        n = 0
        for rec in self._records():
            idx = n
            n += 1
            in_shard = (idx % self.shard_total) == self.shard_index
            if in_shard and (not rec.is_unmapped) and \
                    rec.mapq >= self.min_mapping_quality:
                buf.append((idx, rec))
            if n % self.batch_size == 0:
                yield buf
                buf = []
            if self.max_reads is not None and n >= self.max_reads:
                break
        if buf:
            yield buf

    def close(self):
        self.reader.close()
