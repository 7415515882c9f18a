"""nanopolish_tpu_torch read ingest (build_reads: event detection, MoM,
banded alignment, 'M'-event WLS recalibration, QC) against the JAX
package's build_reads on the same synthetic raw reads.

Per-read scalings within rtol 1e-5 (see test_torch_scaling.py for why
not bit-exact by contract); base->event maps, QC verdicts, event tables
and the ReadStats skip counters identical.
"""

import numpy as np
import pytest
import torch

from nanopolish_tpu.models.pore_model import PoreModelSet as JaxModels
from nanopolish_tpu.models.read_builder import RawReadInput as JaxInput
from nanopolish_tpu.models.read_builder import ReadStats as JaxStats
from nanopolish_tpu.models.read_builder import build_reads as jax_build
from nanopolish_tpu.models.squiggle import SquiggleScalings, T_IDX
from nanopolish_tpu.utils.synthetic import random_sequence, synthetic_raw_signal
from nanopolish_tpu_torch.models import read_builder as trb

torch.set_num_threads(2)

STAT_FIELDS = ("total_reads", "unparseable_reads", "qc_fail_reads",
               "failed_calibration_reads", "failed_alignment_reads",
               "bad_fast5_file")


@pytest.fixture(scope="module")
def raw_reads():
    model = JaxModels.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    rng = np.random.default_rng(3)
    reads = []
    for i, (n, shift, scale) in enumerate(
            [(420, 15.0, 1.1), (300, 1.5, 1.01), (480, -4.0, 0.97)]):
        seq = random_sequence(rng, n)
        raw = synthetic_raw_signal(
            rng, seq, model, SquiggleScalings.from4(shift, scale, 0.0, 1.0),
            samples_per_base=10.0, leader=300, trailer=60)
        reads.append((f"r{i}", seq, raw))
    # a garbage signal that fails the banded QC
    seq = random_sequence(rng, 350)
    reads.append(("junk", seq, rng.uniform(40, 140, 3500).astype(np.float32)))
    # unparseable: too short a sequence
    reads.append(("bad", "ACGT", np.ones(10, np.float32)))
    return reads


def test_build_reads_matches_jax(raw_reads):
    js, ts = JaxStats(), trb.ReadStats()
    ref = jax_build([JaxInput(read_name=n, sequence=s, raw=r)
                     for n, s, r in raw_reads], stats=js)
    got = trb.build_reads([trb.RawReadInput(read_name=n, sequence=s, raw=r)
                           for n, s, r in raw_reads], stats=ts, device="cpu")
    for f in ("total_reads", "unparseable_reads", "qc_fail_reads",
              "failed_calibration_reads", "failed_alignment_reads",
              "bad_fast5_file"):
        assert getattr(ts, f) == getattr(js, f), f
    assert js.failed_alignment_reads >= 1 and js.bad_fast5_file == 1
    n_ok = 0
    for a, b in zip(ref, got):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert a.read_name == b.read_name
        assert a.has_events_for_strand(T_IDX) == b.has_events_for_strand(T_IDX)
        assert a.events_per_base[T_IDX] == b.events_per_base[T_IDX]
        ma, mb = a.base_to_event_map[T_IDX], b.base_to_event_map[T_IDX]
        assert (ma is None) == (mb is None)
        if ma is not None:
            np.testing.assert_array_equal(ma, mb)
        if not a.has_events_for_strand(T_IDX):
            continue
        n_ok += 1
        np.testing.assert_array_equal(a.events[T_IDX].mean, b.events[T_IDX].mean)
        sa, sb = a.scalings[T_IDX], b.scalings[T_IDX]
        np.testing.assert_allclose([sb.shift, sb.scale, sb.drift, sb.var],
                                   [sa.shift, sa.scale, sa.drift, sa.var],
                                   rtol=1e-5)
    assert n_ok >= 2


def test_build_reads_needs_a_device_or_cpu(raw_reads):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    n, s, r = raw_reads[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trb.build_reads([trb.RawReadInput(read_name=n, sequence=s, raw=r)])


def _read_fields(r):
    if r is None:
        return None
    s = r.scalings[T_IDX]
    m = r.base_to_event_map[T_IDX]
    return (r.read_name, r.has_events_for_strand(T_IDX),
            float(r.events_per_base[T_IDX]),
            None if m is None else m.tobytes(),
            (s.shift, s.scale, s.drift, s.var),
            None if r.events[T_IDX] is None else r.events[T_IDX].mean.tobytes())


def test_ingest_chunks_equal_one_chunk_and_jax(raw_reads):
    """max_batch=1 makes a chunk of each read, each resolved before the
    next is issued: the reads and ReadStats are those of one chunk of all
    the reads, and both equal the JAX build_reads (a read's result does
    not depend on its chunk)."""
    inputs = [trb.RawReadInput(read_name=n, sequence=s, raw=r)
              for n, s, r in raw_reads]
    got = {}
    for mode, max_batch in (("chunks", 1), ("one", len(inputs))):
        stats = trb.ReadStats()
        reads = trb.build_reads(inputs, stats=stats, max_batch=max_batch,
                                device="cpu")
        got[mode] = ([_read_fields(r) for r in reads],
                     [getattr(stats, f) for f in STAT_FIELDS])
    assert got["chunks"] == got["one"]
    js = JaxStats()
    ref = jax_build([JaxInput(read_name=n, sequence=s, raw=r)
                     for n, s, r in raw_reads], stats=js)
    assert got["chunks"][1] == [getattr(js, f) for f in STAT_FIELDS]
    for a, b in zip(ref, got["chunks"][0]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        want = _read_fields(a)
        assert want[:4] == b[:4] and want[5] == b[5]
        np.testing.assert_allclose(b[4], want[4], rtol=1e-5)
    assert sum(r is not None and r[1] for r in got["chunks"][0]) >= 2
