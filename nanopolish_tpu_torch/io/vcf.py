"""VCF reading/writing + the Variant record.

Rebuild of the reference's Variant/VCF layer
(reference: src/common/nanopolish_variant.{h,cpp}:21-128 — a minimal
hand-rolled VCF, not htslib's): tab-separated records with INFO key=value
pairs, sorted by (ref_name, ref_position), plus nanopolish-specific header
lines (##nanopolish_window) used by vcf2fasta tiling checks
(src/nanopolish_vcf2fasta.cpp:138-216).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, TextIO, Tuple


@dataclass
class Variant:
    """One variant (src/common/nanopolish_variant.h:21-128). ref_position
    is 0-based internally, 1-based in VCF text."""

    ref_name: str = ""
    ref_position: int = -1
    ref_seq: str = ""
    alt_seq: str = ""
    quality: float = 0.0
    info: Dict[str, str] = field(default_factory=dict)
    genotype: str = "."
    filter: str = "PASS"

    def key(self) -> str:
        return f"{self.ref_name}:{self.ref_position}:{self.ref_seq}:{self.alt_seq}"

    def add_info(self, key: str, value):
        if isinstance(value, float):
            self.info[key] = f"{value:.2f}"
        else:
            self.info[key] = str(value)

    def is_snp(self) -> bool:
        return len(self.ref_seq) == 1 and len(self.alt_seq) == 1

    def to_vcf_line(self) -> str:
        info = ";".join(f"{k}={v}" for k, v in self.info.items()) or "."
        gt = f"\tGT\t{self.genotype}" if self.genotype != "." else "\tGT\t."
        return (f"{self.ref_name}\t{self.ref_position + 1}\t.\t{self.ref_seq}"
                f"\t{self.alt_seq}\t{self.quality:.1f}\t{self.filter}\t{info}{gt}")

    @classmethod
    def from_vcf_line(cls, line: str) -> "Variant":
        f = line.rstrip("\n").split("\t")
        v = cls(ref_name=f[0], ref_position=int(f[1]) - 1, ref_seq=f[3],
                alt_seq=f[4])
        try:
            v.quality = float(f[5])
        except ValueError:
            v.quality = 0.0
        if len(f) > 6:
            v.filter = f[6]
        if len(f) > 7 and f[7] != ".":
            for kv in f[7].split(";"):
                if "=" in kv:
                    k, val = kv.split("=", 1)
                    v.info[k] = val
                else:
                    v.info[kv] = ""
        if len(f) > 9:
            fmt = f[8].split(":")
            sample = f[9].split(":")
            if "GT" in fmt:
                v.genotype = sample[fmt.index("GT")]
        return v


class VcfReader:
    def __init__(self, path: str):
        self.path = path
        self.header_lines: List[str] = []
        self.samples: List[str] = []
        self._records: Optional[List[Variant]] = None
        with open(path) as fh:
            for line in fh:
                if line.startswith("##"):
                    self.header_lines.append(line.rstrip("\n"))
                elif line.startswith("#CHROM"):
                    self.header_lines.append(line.rstrip("\n"))
                    self.samples = line.rstrip("\n").split("\t")[9:]
                    break

    def __iter__(self) -> Iterator[Variant]:
        with open(self.path) as fh:
            for line in fh:
                if not line.startswith("#") and line.strip():
                    yield Variant.from_vcf_line(line)

    def records(self) -> List[Variant]:
        if self._records is None:
            self._records = list(self)
        return self._records

    def window(self) -> Optional[Tuple[str, int, int]]:
        """Parse ##nanopolish_window=ctg:start-end (vcf2fasta.cpp:156-176)."""
        for line in self.header_lines:
            if line.startswith("##nanopolish_window="):
                val = line.split("=", 1)[1]
                ctg, rng = val.rsplit(":", 1)
                s, e = rng.split("-")
                return ctg, int(s), int(e)
        return None


class VcfWriter:
    def __init__(self, out: TextIO, sample: str = "sample",
                 extra_header: Optional[List[str]] = None):
        self._out = out
        self.sample = sample
        self.extra_header = extra_header or []
        self._wrote_header = False

    def write_header(self, info_fields: Optional[List[Tuple[str, str, str, str]]] = None):
        w = self._out.write
        w("##fileformat=VCFv4.2\n")
        for line in self.extra_header:
            w(line.rstrip("\n") + "\n")
        for fid, num, typ, desc in (info_fields or DEFAULT_INFO_FIELDS):
            w(f'##INFO=<ID={fid},Number={num},Type={typ},Description="{desc}">\n')
        w('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        w("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
          + self.sample + "\n")
        self._wrote_header = True

    def write_variant(self, v: Variant):
        if not self._wrote_header:
            self.write_header()
        self._out.write(v.to_vcf_line() + "\n")


# INFO fields emitted by variants --consensus
# (src/common/nanopolish_variant.cpp:23-51)
DEFAULT_INFO_FIELDS = [
    ("TotalReads", "1", "Integer", "The number of event-space reads used to call the variant"),
    ("SupportFraction", "1", "Float", "The fraction of event-space reads that support the variant"),
    ("SupportFractionByStrand", "2", "Float", "Fraction of event-space reads that support the variant for each strand"),
    ("BaseCalledReadsWithVariant", "1", "Integer", "The number of base-space reads that support the variant"),
    ("BaseCalledFraction", "1", "Float", "The fraction of base-space reads that support the variant"),
    ("AlleleCount", "1", "Integer", "The inferred number of copies of the allele"),
    ("StrandSupport", "4", "Integer", "Number of reads supporting the ref and alt allele on each strand"),
    ("StrandFisherTest", "1", "Integer", "Strand bias fisher test"),
    ("SOR", "1", "Float", "StrandOddsRatio test from GATK"),
    ("RefContext", "1", "String", "The reference sequence context surrounding the variant call"),
]
