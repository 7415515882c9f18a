"""nanopolish_tpu_torch profile-HMM Forward against the JAX package.

The port's plain Forward (ops/profile_hmm.forward_fill_plain, the plain
version of csrc/forward_fill.cu) follows the JAX scan path
(profile_hmm_forward) operation for operation, but logaddexp's exp and
log1p are XLA's polynomials on one side and torch's on the other, so the
scores may differ in the last bits.  The bar is the one the JAX package
holds its own Pallas Forward to against the scan
(tests/test_pallas_profile_hmm.py:39): atol 2e-3 nats, rtol 0.  Both
sides get the same numpy inputs and the same transition table.  Within
the port, bucketing and mixed clip flags must not change a score at all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopolish_tpu.models.pore_model import PoreModelSet
from nanopolish_tpu.ops.profile_hmm import (BlockTransitions, _kstate_scan,
                                            profile_hmm_forward)
from nanopolish_tpu_torch.alignment.segments import (HMMSegment,
                                                     forward_arrays,
                                                     forward_segments)
from nanopolish_tpu_torch.ops import profile_hmm as ph
from nanopolish_tpu_torch.ops import profile_hmm_forward as pf
from nanopolish_tpu_torch.utils.logsum import add_logs_exact
from tests.kchain_lanes import (chain_inputs, lane_schedule_chain,
                                wide_schedule_chain)
from tests.printed_output import assert_agree

torch.set_num_threads(2)

ATOL = 2e-3


def _batch(B, Kmax, Tmax, seed=0, epb=None, full=False):
    """B segments of Kmax/2..Kmax kmers and Tmax/2..Tmax events (all
    Kmax x Tmax when full) with levels drawn along a uniform path."""
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    rng = np.random.default_rng(seed)
    Ks = np.full(B, Kmax) if full else rng.integers(Kmax // 2, Kmax, B)
    Ts = np.full(B, Tmax) if full else rng.integers(Tmax // 2, Tmax, B)
    mu = np.zeros((B, Kmax), np.float32)
    sd = np.ones((B, Kmax), np.float32)
    lv = np.zeros((B, Tmax), np.float32)
    for b in range(B):
        ranks = rng.integers(0, 4096, Ks[b])
        mu[b, :Ks[b]] = model.level_mean[ranks]
        sd[b, :Ks[b]] = model.level_stdv[ranks]
        reps = np.minimum((np.arange(Ts[b]) / (Ts[b] / Ks[b])).astype(int),
                          Ks[b] - 1)
        lv[b, :Ts[b]] = mu[b, reps] + rng.normal(0, 1, Ts[b]) * sd[b, reps]
    if epb is None:
        epb = rng.uniform(1.5, 2.5, B).astype(np.float32)
    return lv, Ts.astype(np.int32), mu, sd, Ks.astype(np.int32), \
        np.broadcast_to(np.float32(epb), (B,)).copy()


def _jax_trans(table):
    cols = (0, 1, 2, 3, 4, 5, 5, 5, 6, 7)     # BlockTransitions field order
    return BlockTransitions(*[jnp.asarray(table[:, i]) for i in cols])


def _report(got, ref):
    d = np.abs(got.astype(np.float64) - np.asarray(ref, np.float64))
    print(f"max |port - JAX| = {d.max():.3g} nats over {len(d)} segments, "
          f"{np.mean(got == ref):.0%} bit-identical")


@pytest.mark.parametrize("shape", [(8, 30, 60, False), (6, 150, 280, False),
                                   (4, 250, 501, True)])
@pytest.mark.parametrize("flags", [0, 1, 2, 3])
def test_plain_matches_jax_scan(shape, flags):
    """Small shapes, and the scorereads shape (501 events x 250 kmers)."""
    B, K, T, full = shape
    lv, Ts, mu, sd, Ks, epb = _batch(B, K, T, seed=flags, full=full)
    table = ph.make_transitions(epb)
    ref = np.asarray(profile_hmm_forward(lv, Ts, mu, sd, np.log(sd), Ks, epb,
                                         flags=flags,
                                         trans=_jax_trans(table)))
    got = pf.profile_hmm_forward(lv, Ts, mu, sd, Ks, epb, flags,
                                 device="cpu")
    _report(got, ref)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("flags", [0, 3])
def test_plain_matches_pallas_interpret(flags):
    """The shapes of tests/test_pallas_profile_hmm.py, against the Pallas
    kernel in interpret mode (its own transitions: the same f64 table)."""
    from nanopolish_tpu.ops.pallas_profile_hmm import profile_hmm_forward_pallas
    lv, Ts, mu, sd, Ks, epb = _batch(6, 150, 280, seed=flags, epb=2.2)
    ref = profile_hmm_forward_pallas(lv, Ts, mu, sd, np.log(sd), Ks, epb,
                                     flags)
    got = pf.profile_hmm_forward(lv, Ts, mu, sd, Ks, epb, flags,
                                 device="cpu")
    _report(got, ref)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 2, 5, 32, 33, 100, 128, 221])
def test_kchain_logsum_matches_associative_scan(n):
    rng = np.random.default_rng(n)
    c = rng.normal(-200, 30, (3, n)).astype(np.float32)
    c[:, ::7] = -np.inf
    lp_kk = np.array([np.log(0.3), np.log(0.25), np.log(0.7)], np.float32)
    ref = np.asarray(_kstate_scan(jnp.asarray(c), jnp.asarray(lp_kk),
                                  viterbi=False))
    got = ph.kstate_chain_logsum(torch.from_numpy(c),
                                 torch.from_numpy(lp_kk)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))


@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_lane_schedule_matches_kstate_chain_logsum(R):
    """The warp kernels' in-place lane schedule of the K chain (R kmers
    per lane, register levels then lane levels; tests/kchain_lanes.py)
    gives kstate_chain_logsum's values bit for bit, -inf runs included."""
    rng = np.random.default_rng(200 + R)
    c, lp_kk = chain_inputs(rng, 8, 32 * R)

    def op(x, y):
        return add_logs_exact(torch.from_numpy(np.ascontiguousarray(x)),
                              torch.from_numpy(np.ascontiguousarray(y))
                              ).numpy()

    got = lane_schedule_chain(c, lp_kk, R, op)
    ref = ph.kstate_chain_logsum(torch.from_numpy(c),
                                 torch.from_numpy(lp_kk)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("J,nt,C", [(1, 32, 1), (1, 64, 2), (2, 64, 4),
                                    (4, 32, 8), (1, 256, 8), (8, 64, 1),
                                    (16, 32, 2), (1, 1024, 8)])
def test_wide_schedule_matches_kstate_chain_logsum(J, nt, C):
    """The wide row's tiers (csrc/profile_hmm_wide.cuh; J kmers a thread,
    nt threads a CTA, C CTAs a segment; tests/kchain_lanes.py
    wide_schedule_chain) give kstate_chain_logsum's values bit for bit,
    -inf runs included, the train step's geometry (1 x 1,024 x 8) too."""
    rng = np.random.default_rng(300 + J * 1000 + nt + C)
    c, lp_kk = chain_inputs(rng, 4, J * nt * C)

    def op(x, y):
        return add_logs_exact(torch.from_numpy(np.ascontiguousarray(x)),
                              torch.from_numpy(np.ascontiguousarray(y))
                              ).numpy()

    got = wide_schedule_chain(c, lp_kk, J, nt, C, op)
    ref = ph.kstate_chain_logsum(torch.from_numpy(c),
                                 torch.from_numpy(lp_kk)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("kp,B", [(2048, 8), (8192, 4), (8192, 64),
                                  (32768, 68)])
def test_forward_fill_launch_geometry(monkeypatch, kp, B):
    """forward_fill hands the kernel wide_layout's kpl, threads a CTA and
    CTAs a segment (the Forward's rows: 12 bytes a kmer), and a scratch
    buffer exactly when its rows are in scratch."""
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv
    from nanopolish_tpu_torch.utils import cuda_build
    calls = []
    monkeypatch.setattr(cuda_build, "require_cuda", lambda t: None)
    monkeypatch.setattr(cuda_build, "launch",
                        lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(cuda_build, "count_launch", lambda name: None)
    monkeypatch.setattr(pv, "card_sms", lambda dev: 132)
    meta = torch.device("meta")
    f32, i32 = torch.float32, torch.int32
    args = [torch.empty((B, 7), dtype=f32, device=meta),
            torch.empty(B, dtype=i32, device=meta)]
    args += [torch.empty((B, kp), dtype=f32, device=meta) for _ in range(3)]
    args += [torch.empty(B, dtype=i32, device=meta),
             torch.empty((B, 8), dtype=f32, device=meta),
             torch.empty((B, 2), dtype=torch.uint8, device=meta)]
    pf.forward_fill(*args)
    (name, a), = calls
    lay = pv.wide_layout(kp, B, False)
    assert name == "forward_fill" and a[5] == kp
    assert a[6:9] == (lay.per_thread, lay.threads, lay.cluster)
    kpl, threads, cluster, scratch = pv.fill_geometry(kp, B, False, meta)
    assert (kpl, threads, cluster) == a[6:9]
    assert (scratch is None) == (lay.rows == "shared")


@pytest.mark.parametrize("W", [8, 16])
def test_segmented_lane_schedule_matches_kstate_chain_logsum(W):
    """forward_indexed.cu's short windows: 32 / W segments per warp, one
    kmer per lane, every shuffle on groups of W lanes (the width argument
    of __shfl_up_sync).  Each group's K chain gives kstate_chain_logsum's
    values of its own W kmers bit for bit, with its own lp_kk and no
    value crossing from another group."""
    rng = np.random.default_rng(300 + W)
    G = 32 // W
    c, lp_kk = chain_inputs(rng, 8 * G, W + 8)
    c = c[:, :W]
    lp_kk = lp_kk[rng.permutation(8 * G)]

    def op(x, y):
        return add_logs_exact(torch.from_numpy(np.ascontiguousarray(x)),
                              torch.from_numpy(np.ascontiguousarray(y))
                              ).numpy()

    got = lane_schedule_chain(c.reshape(8, 32), lp_kk.reshape(8, G), 1, op,
                              width=W)
    ref = ph.kstate_chain_logsum(torch.from_numpy(c),
                                 torch.from_numpy(lp_kk)).numpy()
    np.testing.assert_array_equal(got.reshape(8 * G, W).view(np.int32),
                                  ref.view(np.int32))


@pytest.mark.parametrize("R", [1, 2, 4])
def test_eight_lane_windows_match_kstate_chain_logsum(R):
    """forward_indexed.cu's windows of up to 32 kmers: 8 lanes a window,
    R kmers a lane, 4 windows a warp.  Windows of mixed widths 1 .. 8 R,
    each padded to 8 R with other values, give on their own kmers the
    bits of kstate_chain_logsum over those kmers alone and over them
    padded to one group of 32: the grouping changes no value."""
    rng = np.random.default_rng(400 + R)
    kp, n = 8 * R, 32
    c, lp_kk = chain_inputs(rng, n, kp + 8)
    c = c[:, :kp]
    widths = rng.integers(1, kp + 1, n)
    pad = rng.normal(-50.0, 20.0, (n, kp)).astype(np.float32)
    c = np.where(np.arange(kp)[None, :] < widths[:, None], c, pad)

    def op(x, y):
        return add_logs_exact(torch.from_numpy(np.ascontiguousarray(x)),
                              torch.from_numpy(np.ascontiguousarray(y))
                              ).numpy()

    got = lane_schedule_chain(c.reshape(n // 4, 4 * kp),
                              lp_kk.reshape(n // 4, 4), R, op,
                              width=8).reshape(n, kp)
    wide = np.pad(c, ((0, 0), (0, 32 - kp)), constant_values=-7.0)
    one_group = ph.kstate_chain_logsum(torch.from_numpy(wide),
                                       torch.from_numpy(lp_kk)).numpy()
    for i, w in enumerate(widths):
        alone = ph.kstate_chain_logsum(
            torch.from_numpy(c[i:i + 1, :w].copy()),
            torch.from_numpy(lp_kk[i:i + 1])).numpy()[0]
        np.testing.assert_array_equal(got[i, :w].view(np.int32),
                                      alone.view(np.int32))
        np.testing.assert_array_equal(one_group[i, :w].view(np.int32),
                                      alone.view(np.int32))


def test_logaddexp_matches_jnp():
    rng = np.random.default_rng(0)
    x = rng.normal(-100, 40, 4096).astype(np.float32)
    y = rng.normal(-100, 40, 4096).astype(np.float32)
    x[:64] = -np.inf
    y[32:96] = -np.inf
    ref = np.asarray(jnp.logaddexp(x, y))
    got = add_logs_exact(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=2e-7, atol=0)


def test_mixed_flags_one_batch_bit_identical():
    lv, Ts, mu, sd, Ks, epb = _batch(8, 120, 250, seed=9)
    flags = np.array([0, 1, 2, 3, 3, 2, 1, 0], np.int32)
    mixed = pf.profile_hmm_forward(lv, Ts, mu, sd, Ks, epb, flags,
                                   device="cpu")
    for f in range(4):
        sel = flags == f
        alone = pf.profile_hmm_forward(lv[sel], Ts[sel], mu[sel], sd[sel],
                                       Ks[sel], epb[sel], f, device="cpu")
        np.testing.assert_array_equal(mixed[sel], alone)


def test_bucket_padding_bit_identical():
    """Padding kmers (a wider bucket) or events changes no score
    (compare tests/test_pallas_profile_hmm.py:74)."""
    lv, Ts, mu, sd, Ks, epb = _batch(8, 40, 160, seed=9)
    narrow = pf.profile_hmm_forward(lv, Ts, mu, sd, Ks, epb, 3, device="cpu")
    mu2 = np.pad(mu, ((0, 0), (0, 160)))
    sd2 = np.pad(sd, ((0, 0), (0, 160)), constant_values=1.0)
    lv2 = np.pad(lv, ((0, 0), (0, 300)))
    wide = pf.profile_hmm_forward(lv2, Ts, mu2, sd2, Ks, epb, 3,
                                  device="cpu")
    np.testing.assert_array_equal(narrow, wide)


def test_forward_segments_match_direct_call():
    """forward_segments buckets mixed-size segments by power-of-two shape;
    each score equals the segment scored alone."""
    lv, Ts, mu, sd, Ks, epb = _batch(10, 200, 400, seed=4)
    segs = [HMMSegment(levels=lv[b, :Ts[b]], mu=mu[b, :Ks[b]],
                       sigma=sd[b, :Ks[b]], events_per_base=float(epb[b]),
                       flags=b % 4) for b in range(10)]
    got = forward_segments(segs, device="cpu")
    for b in range(len(segs)):
        alone = pf.profile_hmm_forward(lv[b:b + 1], Ts[b:b + 1],
                                       mu[b:b + 1], sd[b:b + 1], Ks[b:b + 1],
                                       epb[b:b + 1], b % 4, device="cpu")
        assert got[b] == alone[0]
    arr = forward_arrays(lv, Ts, mu, sd, Ks, epb, np.arange(10) % 4,
                         device="cpu")
    np.testing.assert_array_equal(arr, got)


def test_no_events_scores_neg_inf():
    lv, Ts, mu, sd, Ks, epb = _batch(3, 40, 80, seed=2)
    Ts[1] = 0
    got = pf.profile_hmm_forward(lv, Ts, mu, sd, Ks, epb, 3, device="cpu")
    assert got[1] == -np.inf and np.isfinite(got[[0, 2]]).all()


@pytest.mark.parametrize("K,T,flags", [(1100, 500, 3), (1100, 500, 0),
                                         (20000, 40, 3), (3000, 120, 1),
                                         (7995, 60, 0), (12000, 40, 2)])
def test_wide_segment_matches_jax_scan(K, T, flags):
    """A segment wider than 1,024 kmers (a 500-event scorereads chunk
    across deletions: 1,100 kmers; the wide row at 2,048) and one whose
    rows need the wide row's global scratch on the card when the batch
    keeps one CTA a segment (20,000 kmers: width 32,768, 384 KB of rows)
    score as the JAX scan scores them, under the printed-output rule of
    scorereads' per-event score; so do segments at the widths where
    wide_layout's geometry changes (4,096; 16,384, the widest row one CTA
    holds in shared memory) and a whole read of the train step's kmer
    width with its flags (7,995 kmers at 8,192, no clips)."""
    from nanopolish_tpu.alignment import segments as jseg
    lv, Ts, mu, sd, Ks, epb = _batch(1, K, T, seed=K + flags, full=True)
    want = jseg.forward_segments([jseg.HMMSegment(
        lv[0], mu[0], sd[0], float(epb[0]), flags)])
    got = forward_segments([HMMSegment(lv[0], mu[0], sd[0], float(epb[0]),
                                       flags)], device="cpu")
    assert np.isfinite(got).all()
    assert_agree(f"{got[0] / T:.3f}\n", f"{want[0] / T:.3f}\n",
                 f"forward {K} kmers x {T} events")
    np.testing.assert_allclose(got, want, atol=ATOL * T, rtol=0)


def test_wide_bucket_padding_bit_identical():
    """A segment of 1,000 kmers scores the same bits at kmer width 1,024
    (block row) and 2,048 (wide row): the row layouts of the card all
    compute the padding-invariant function of forward_fill_plain."""
    lv, Ts, mu, sd, Ks, epb = _batch(3, 1000, 60, seed=5)
    x1 = pf.prepare_forward_inputs(lv, Ts, mu, sd, Ks, epb, 3, device="cpu")
    x2 = pf.prepare_forward_inputs(
        lv, Ts, np.pad(mu, ((0, 0), (0, 1048))),
        np.pad(sd, ((0, 0), (0, 1048)), constant_values=1.0), Ks, epb, 3,
        device="cpu")
    assert x1["mu"].shape[1] == 1024 and x2["mu"].shape[1] == 2048
    a, b = pf.forward_scores(x1), pf.forward_scores(x2)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA Forward kernel has no CPU "
                    "mode (its plain version is tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kp,B,T", [(2048, 8, 60), (8192, 1, 40),
                                    (8192, 4, 40), (8192, 64, 12),
                                    (16384, 68, 8), (32768, 68, 8)])
def test_wide_geometries_match_plain_on_gpu(cuda_device, kp, B, T):
    """The wide row at each kind of wide_layout geometry (clusters of 8, 2
    and 1 CTA a segment, rows in shared memory and in scratch), scores bit
    for bit."""
    lv, Ts, mu, sd, Ks, epb = _batch(B, kp, T, seed=kp + B)
    Ks[0] = kp - 1
    flags = np.arange(B, dtype=np.int32) % 4
    x = pf.prepare_forward_inputs(lv, Ts, mu, sd, Ks, epb, flags,
                                  device=cuda_device)
    assert x["mu"].shape[1] == kp
    got = pf.forward_scores(x)
    ref = ph.forward_fill_plain(x["levels"], x["n_events"], x["mu"],
                                x["sigma"], x["c"], x["n_kmers"], x["trans"],
                                x["clips"])
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kp", [32, 64, 128, 256, 512, 2048, 32768])
def test_kernel_matches_plain_on_gpu(cuda_device, kp):
    """Every row layout (warp kernel at R = 1, 2, 4, 8; block kernel at
    512; wide row at 2,048, and at 32,768 with its rows in global
    scratch), bit for bit: n_kmers not a multiple of 32 R, all four clip
    flags, one segment with a single event."""
    B, T = (64, 2 * kp + 20) if kp <= 512 else (8, 48)
    lv, Ts, mu, sd, Ks, epb = _batch(B, kp, T, seed=kp)
    Ks[0] = kp - 1
    Ts[1] = 1
    flags = np.arange(B, dtype=np.int32) % 4
    x = pf.prepare_forward_inputs(lv, Ts, mu, sd, Ks, epb, flags,
                                  device=cuda_device)
    assert x["mu"].shape[1] == kp
    got = pf.forward_scores(x)
    ref = ph.forward_fill_plain(x["levels"], x["n_events"], x["mu"],
                                x["sigma"], x["c"], x["n_kmers"], x["trans"],
                                x["clips"])
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
