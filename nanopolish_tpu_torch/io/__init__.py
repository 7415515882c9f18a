from .bam import BamReader, BamRecord, BamWriter, aligned_pairs  # noqa: F401
from .bgzf import BgzfReader, BgzfWriter, is_bgzf  # noqa: F401
from .fasta import FastaIndex, build_fai, read_fastx, write_bgzf_fasta  # noqa: F401
from .fast5 import Fast5Data, Fast5File, load_read  # noqa: F401
from .readdb import ReadDB, find_signal_files, index_signal_files  # noqa: F401
from .slow5 import Blow5Writer, Slow5File, Slow5Record, Slow5Writer  # noqa: F401
from .vcf import Variant, VcfReader, VcfWriter  # noqa: F401
