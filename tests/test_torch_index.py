"""nanopolish_tpu_torch `index` with its signal-locating options against
the JAX package's app: ``-f/--fast5-fofn`` (a file of signal file
names) and ``-s/--sequencing-summary`` (read ids to file names, resolved
against ``-d`` directories).  Both apps index the same fastq, each in a
directory of its own, and must write the same read database, byte for
byte.  The signal files are slow5, written as tests/test_io.py writes
them, so nothing needs h5py.
"""

import os
import shutil

import numpy as np
import pytest

from nanopolish_tpu_torch.apps import index as index_app
from nanopolish_tpu_torch.io import readdb
from nanopolish_tpu_torch.io.slow5 import Slow5Writer

READS = [f"read{i}" for i in range(4)]


@pytest.fixture(scope="module")
def signal_dir(tmp_path_factory):
    """reads.fastq of four reads and their signal in sig/sig.slow5, with a
    fofn naming the slow5 file and a sequencing summary mapping every
    read to it."""
    d = tmp_path_factory.mktemp("torch_index")
    rng = np.random.default_rng(3)
    with open(d / "reads.fastq", "w") as fq:
        for name in READS:
            seq = "".join(rng.choice(list("ACGT"), 50))
            fq.write(f"@{name}\n{seq}\n+\n{'I' * 50}\n")
    sig = d / "sig"
    sig.mkdir()
    with Slow5Writer(str(sig / "sig.slow5")) as w:
        for name in READS:
            w.write(name, rng.integers(-500, 500, 200).astype(np.int16),
                    8192.0, 0.0, 1400.0, 4000.0)
    (d / "signal.fofn").write_text(str(sig / "sig.slow5") + "\n")
    (d / "sequencing_summary.txt").write_text(
        "filename\tread_id\tsequence_length_template\n" +
        "".join(f"sig.slow5\t{name}\t50\n" for name in READS))
    return d


def _index(app, d, name, opts):
    """Copy reads.fastq into d/name and index it there with ``opts``;
    returns the read database's text."""
    out = d / name
    out.mkdir(exist_ok=True)
    fastq = str(out / "reads.fastq")
    shutil.copy(d / "reads.fastq", fastq)
    app.main([fastq] + opts)
    return open(fastq + readdb.READ_DB_SUFFIX).read()


@pytest.mark.parametrize("case", ["fast5_fofn", "sequencing_summary"])
def test_index_signal_options_match_jax_app(signal_dir, monkeypatch, case):
    """-f names the signal file through a fofn (slow5 mode: one ``*``
    line, where an index without it links no read to signal); -s with -d
    links every read to its file by name (the summary's map is imported,
    where -d alone puts the slow5 file in slow5 mode)."""
    from nanopolish_tpu.apps import index as jax_app
    d = signal_dir
    sig = str(d / "sig" / "sig.slow5")
    opts = {"fast5_fofn": ["-f", str(d / "signal.fofn")],
            "sequencing_summary": ["-d", str(d / "sig"), "-s",
                                   str(d / "sequencing_summary.txt")]}[case]
    imported = []
    real = readdb.ReadDB.import_signal_map

    def spy(db, paths):
        imported.append(dict(paths))
        return real(db, paths)

    want = _index(jax_app, d, f"jax_{case}", opts)
    monkeypatch.setattr(readdb.ReadDB, "import_signal_map", spy)
    got = _index(index_app, d, f"port_{case}", opts)
    assert got == want
    if case == "fast5_fofn":
        assert got == f"*\t{sig}\n" and not imported
        assert _index(index_app, d, "port_none", []) == "".join(
            f"{name}\t\n" for name in READS)
    else:
        assert imported == [{name: sig for name in READS}]
        assert got == "".join(f"{name}\t{sig}\n" for name in READS)
        assert _index(index_app, d, "port_dir", opts[:2]) == f"*\t{sig}\n"
