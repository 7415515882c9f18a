"""nanopolish_tpu_torch's legacy R7 path against the JAX package's:
``io.fast5_legacy.load_legacy_2d``, ``ops.profile_hmm_r7.R7Scorer`` and the
hmmer3 logsum table (``utils.logsum.add_logs_np(..., table=True)``).

The reference's R7 golden file is not in the repository
(tests/test_r7_golden.py skips without it), so both packages read the
same synthetic legacy 2D strands, written here with h5py in the layout
load_legacy_2d reads: per strand a basecalled event table, an embedded
5-mer model with its scalings as attributes, and the strand's FASTQ.
R7Scorer is a host NumPy module in both packages (no device work), so
the bar is identity: the same Viterbi state strings, kmer and event
indices, and Forward and Viterbi log-likelihoods equal bit for bit.
"""

import numpy as np
import pytest

from nanopolish_tpu.io import fast5_legacy as jax_legacy
from nanopolish_tpu.models.hmm_input import HMMInputSequence as JaxSeq
from nanopolish_tpu.models.transition_parameters import \
    TransitionParameters as JaxParams
from nanopolish_tpu.ops import profile_hmm_r7 as jax_r7
from nanopolish_tpu.utils import logsum as jax_logsum
from nanopolish_tpu_torch.io import fast5_legacy
from nanopolish_tpu_torch.models.hmm_input import HMMInputSequence
from nanopolish_tpu_torch.models.transition_parameters import \
    TransitionParameters
from nanopolish_tpu_torch.ops import profile_hmm_r7
from nanopolish_tpu_torch.utils import logsum

h5py = pytest.importorskip("h5py")

K = 5
SEQ_LEN = 400
BASES = "ACGT"


def _strand_events(rng, seq, level_mean, level_stdv, shift, scale, drift,
                   var, t0):
    """Events of one strand: 1-3 events per kmer, a skipped kmer now and
    then, levels from the scaled model plus drift and noise."""
    ranks = [int("".join(str(BASES.index(c)) for c in seq[i:i + K]), 4)
             for i in range(len(seq) - K + 1)]
    mean, stdv, start, length = [], [], [], []
    t = t0
    for r in ranks:
        if rng.random() < 0.08:
            continue
        for _ in range(int(rng.integers(1, 4))):
            dur = float(rng.uniform(0.005, 0.03))
            mean.append(scale * level_mean[r] + shift + drift * (t - t0)
                        + rng.normal(0.0, level_stdv[r] * var))
            stdv.append(float(rng.uniform(0.8, 2.0)))
            start.append(t)
            length.append(dur)
            t += dur
    return (np.array(mean), np.array(stdv), np.array(start),
            np.array(length))


def _write_strand(grp, rng, seq, shift, scale, drift, var, t0):
    kmers = ["".join(BASES[(r >> (2 * (K - 1 - j))) & 3] for j in range(K))
             for r in range(4 ** K)]
    level_mean = rng.uniform(40.0, 75.0, 4 ** K)
    level_stdv = rng.uniform(0.7, 1.6, 4 ** K)
    order = rng.permutation(4 ** K)          # rows in no particular order
    model = np.zeros(4 ** K, dtype=[("kmer", "S5"), ("level_mean", "f8"),
                                    ("level_stdv", "f8"), ("sd_mean", "f8"),
                                    ("sd_stdv", "f8")])
    model["kmer"] = [kmers[i].encode() for i in order]
    model["level_mean"] = level_mean[order]
    model["level_stdv"] = level_stdv[order]
    model["sd_mean"] = rng.uniform(0.5, 2.0, 4 ** K)[order]
    model["sd_stdv"] = rng.uniform(0.1, 0.5, 4 ** K)[order]
    ds = grp.create_dataset("Model", data=model)
    for name, v in (("shift", shift), ("scale", scale), ("drift", drift),
                    ("var", var), ("scale_sd", 1.0), ("var_sd", 1.0)):
        ds.attrs[name] = v
    m, s, st, ln = _strand_events(rng, seq, level_mean, level_stdv, shift,
                                  scale, drift, var, t0)
    ev = np.zeros(len(m), dtype=[("mean", "f8"), ("stdv", "f8"),
                                 ("start", "f8"), ("length", "f8")])
    ev["mean"], ev["stdv"], ev["start"], ev["length"] = m, s, st, ln
    grp.create_dataset("Events", data=ev)
    grp.create_dataset("Fastq", data=np.bytes_(
        f"@read\n{seq}\n+\n{'I' * len(seq)}\n"))
    return len(m)


@pytest.fixture(scope="module")
def legacy_fast5(tmp_path_factory):
    """A legacy 2D fast5 whose template strand reads the sequence and whose
    complement strand reads its reverse complement."""
    rng = np.random.default_rng(77)
    seq = "".join(rng.choice(list(BASES), SEQ_LEN))
    rc = seq[::-1].translate(str.maketrans("ACGT", "TGCA"))
    path = str(tmp_path_factory.mktemp("r7") / "legacy_strand.fast5")
    with h5py.File(path, "w") as f:
        bc = f.create_group("Analyses").create_group("Basecall_2D_000")
        n_t = _write_strand(bc.create_group("BaseCalled_template"), rng, seq,
                            shift=2.07, scale=0.97, drift=0.5, var=1.1,
                            t0=1000.0)
        n_c = _write_strand(bc.create_group("BaseCalled_complement"), rng, rc,
                            shift=-1.3, scale=1.04, drift=-0.3, var=1.25,
                            t0=1100.0)
        bc.create_group("BaseCalled_2D").create_dataset(
            "Fastq", data=np.bytes_(f"@read\n{seq}\n+\n{'I' * SEQ_LEN}\n"))
    return path, seq, n_t, n_c


def test_load_legacy_2d_matches_jax(legacy_fast5):
    path, seq, n_t, n_c = legacy_fast5
    got = fast5_legacy.load_legacy_2d(path)
    want = jax_legacy.load_legacy_2d(path)
    assert got.read_name == want.read_name
    assert got.twod_sequence == want.twod_sequence == seq
    assert set(got.strands) == set(want.strands) == {0, 1}
    assert len(got.strands[0].mean) == n_t and len(got.strands[1].mean) == n_c
    for s in (0, 1):
        a, b = got.strands[s], want.strands[s]
        assert a.k == b.k == K
        assert a.sequence == b.sequence
        for f in ("mean", "stdv", "start", "length", "level_mean",
                  "level_stdv", "sd_mean", "sd_stdv"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype == np.float64, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        for f in ("shift", "scale", "drift", "var", "scale_sd", "var_sd"):
            assert getattr(a, f) == getattr(b, f), f
        idx = np.arange(5, 40)
        np.testing.assert_array_equal(a.drift_scaled_level(idx),
                                      b.drift_scaled_level(idx))


def _window(seq, strand, n_events):
    """A golden-test-shaped case: a ~96-base reference subsequence and the
    events that read it, forward on the template and backward (rc) on the
    complement (nanopolish_test.cpp:389-455)."""
    lo, hi = 120, 216
    sub = seq[lo:hi]
    if strand == 0:
        e0 = int(lo * n_events / SEQ_LEN)
        return sub, e0, e0 + 110, False
    e0 = n_events - 1 - int(lo * n_events / SEQ_LEN)
    return sub, e0, e0 - 110, True


@pytest.mark.parametrize("strand", [0, 1])
@pytest.mark.parametrize("flags", [0, 3])
def test_r7_scorer_matches_jax(legacy_fast5, strand, flags):
    path, seq, n_t, n_c = legacy_fast5
    got_sd = fast5_legacy.load_legacy_2d(path).strands[strand]
    want_sd = jax_legacy.load_legacy_2d(path).strands[strand]
    sub, e0, e1, rc = _window(seq, strand, n_t if strand == 0 else n_c)
    got = profile_hmm_r7.R7Scorer(
        got_sd, TransitionParameters.for_kit("sqkmap005", strand),
        HMMInputSequence(sub), rc, e0, e1)
    want = jax_r7.R7Scorer(
        want_sd, JaxParams.for_kit("sqkmap005", strand), JaxSeq(sub), rc,
        e0, e1)
    states, kis, eis, fms = got.align(flags)
    w_states, w_kis, w_eis, w_fms = want.align(flags)
    assert states == w_states
    assert set(states) <= set("MEK") and states.count("M") > 40
    np.testing.assert_array_equal(kis, w_kis)
    np.testing.assert_array_equal(eis, w_eis)
    assert fms.tobytes() == w_fms.tobytes()
    fwd, w_fwd = got.score(flags), want.score(flags)
    assert np.isfinite(fwd) and fwd == w_fwd
    # Forward sums every path, so it is above the best one's score
    assert fwd >= fms[-1]


def test_r7_scorer_exact_logsum_matches_jax(legacy_fast5):
    """logsum_table=False takes np.logaddexp in both packages."""
    path, seq, n_t, _ = legacy_fast5
    sub, e0, e1, rc = _window(seq, 0, n_t)
    got = profile_hmm_r7.R7Scorer(
        fast5_legacy.load_legacy_2d(path).strands[0],
        TransitionParameters.for_kit("sqkmap005", 0),
        HMMInputSequence(sub), rc, e0, e1, logsum_table=False)
    want = jax_r7.R7Scorer(
        jax_legacy.load_legacy_2d(path).strands[0],
        JaxParams.for_kit("sqkmap005", 0), JaxSeq(sub), rc, e0, e1,
        logsum_table=False)
    assert got.score() == want.score()


def test_logsum_table_matches_jax():
    """add_logs_np(table=True) equals the JAX one over a grid holding -inf,
    0, differences on both sides of the 15.7-nat clamp and at the table's
    0.001-nat steps, in f32 and f64, as arrays and as scalars."""
    np.testing.assert_array_equal(logsum._logsum_table_np(),
                                  jax_logsum._logsum_table_np())
    base = np.array([-np.inf, -1e4, -300.0, -17.0, -15.7, -15.6999, -3.0,
                     -1.0, -0.0015, -0.001, -0.0005, 0.0, 0.0005, 0.001, 2.5,
                     15.7, 15.70001, 16.0, 40.0])
    rng = np.random.default_rng(3)
    vals = np.concatenate([base, rng.uniform(-20.0, 20.0, 400)])
    for dtype in (np.float32, np.float64):
        a, b = np.meshgrid(vals.astype(dtype), vals.astype(dtype))
        got = logsum.add_logs_np(a, b, table=True)
        want = jax_logsum.add_logs_np(a, b, table=True)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        with np.errstate(invalid="ignore"):
            d = np.abs(a - b)
        assert (d >= 15.7).any() and (d == 0).any()
        both_inf = np.isneginf(a) & np.isneginf(b)
        assert np.isneginf(got[both_inf]).all()
    for x, y in ((-np.inf, -np.inf), (0.0, -np.inf), (0.0, 0.0),
                 (np.float32(-2.0), np.float32(-17.8))):
        assert logsum.add_logs_np(x, y, table=True) == \
            jax_logsum.add_logs_np(x, y, table=True)
    np.testing.assert_array_equal(logsum.add_logs_np(vals, vals[::-1]),
                                  np.logaddexp(vals, vals[::-1]))
