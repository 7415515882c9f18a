"""Bridge: ReadDB + signal files -> batched SquiggleRead construction.

The per-read path of the reference (SquiggleRead ctor: ReadDB sequence
fetch + Fast5Loader::load_read + load_from_raw,
src/nanopolish_squiggle_read.cpp:68-116) becomes a batch loader feeding
models/read_builder.build_reads.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..io.readdb import ReadDB
from .read_builder import RawReadInput, ReadStats, build_reads
from .squiggle import SquiggleRead


def load_raw_inputs(read_names: Sequence[str], read_db: ReadDB,
                    stats: Optional[ReadStats] = None,
                    num_threads: int = 8) -> Dict[str, RawReadInput]:
    """Fetch sequence + raw signal for each read name.

    Signal loading (file seeks + zlib/zstd/svb decompression, which release
    the GIL) is threaded across reads — the host-prep parallelism the
    reference gets from `omp parallel for` in BamProcessor (the apps' `-t`
    flag plumbs to num_threads).  Signal file handles are per-thread
    (thread-local cache), so no handle is shared across threads.
    """
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from ..io import fast5 as f5
    from ..io.slow5 import Slow5File

    tls = threading.local()

    def fetch(name):
        seq = read_db.get_read_sequence(name)
        if not seq:
            return None
        path = read_db.get_signal_path(name)
        if not path:
            return None
        if path.endswith((".slow5", ".blow5")):
            cache = getattr(tls, "slow5", None)
            if cache is None:
                cache = tls.slow5 = {}
            sf = cache.get(path)
            if sf is None:
                sf = cache[path] = Slow5File(path)
            rec = sf.get_read(name)
            if rec is None:
                return None
            data = rec.to_fast5_data()
        else:
            data = f5.load_read(path, name)
            if not data.is_valid:
                return None
        return RawReadInput(
            read_name=name,
            sequence=seq,
            raw=data.rt,
            sample_rate=data.channel_params.sample_rate,
            experiment_type=data.experiment_type or "dna",
            sequencing_kit=data.sequencing_kit,
            channel_id=data.channel_id,
            start_time=data.start_time,
        )

    out: Dict[str, RawReadInput] = {}
    if num_threads <= 1:
        fetched = map(fetch, read_names)
    else:
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            fetched = list(pool.map(fetch, read_names))
    for name, inp in zip(read_names, fetched):
        if inp is not None:
            out[name] = inp
    return out


def load_squiggle_reads(read_names: Sequence[str], read_db: ReadDB,
                        flags: int = 0,
                        stats: Optional[ReadStats] = None,
                        num_threads: int = 8,
                        device=None,
                        ) -> Dict[str, SquiggleRead]:
    """Batched SquiggleRead construction for a set of read names; the
    batched ingest runs on ``device`` (``cuda`` unless ``cpu`` is asked)."""
    inputs = load_raw_inputs(read_names, read_db, stats,
                             num_threads=num_threads)
    names = list(inputs)
    reads = build_reads([inputs[n] for n in names], flags=flags, stats=stats,
                        num_threads=num_threads, device=device)
    return {n: r for n, r in zip(names, reads) if r is not None}
