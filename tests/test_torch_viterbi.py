"""nanopolish_tpu_torch profile-HMM Viterbi against the JAX package.

The port's plain PyTorch fill + traceback (ops/profile_hmm.py, the plain
version of csrc/viterbi_fill.cu and csrc/viterbi_backtrack.cu) must give
the JAX scan path's (profile_hmm_viterbi + viterbi_backtrack) tracebacks
exactly, for all four soft-clip flag combinations, and its trace cells
bit for bit.  Both sides get the same numpy inputs and the same
transition table.  The K-skip chain follows jax.lax.associative_scan's
grouping, so even exactly tied optima resolve the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopolish_tpu.models.pore_model import PoreModelSet
from nanopolish_tpu.ops.profile_hmm import (BlockTransitions,
                                            profile_hmm_viterbi,
                                            viterbi_backtrack)
from nanopolish_tpu_torch.ops import profile_hmm as ph
from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv
from tests.backtrack_tiles import MOVES, tiled_paths
from tests.kchain_lanes import (chain_inputs, lane_schedule_chain,
                                wide_schedule_chain)

torch.set_num_threads(2)


def _batch(B, Kmax, Tmax, seed=0):
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    rng = np.random.default_rng(seed)
    Ks = rng.integers(Kmax // 2, Kmax, B)
    Ts = rng.integers(Tmax // 2, Tmax, B)
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
    epb = rng.uniform(1.5, 2.5, B).astype(np.float32)
    return lv, Ts.astype(np.int32), mu, sd, Ks.astype(np.int32), epb


def _jax_trans(table):
    cols = (0, 1, 2, 3, 4, 5, 5, 5, 6, 7)     # BlockTransitions field order
    return BlockTransitions(*[jnp.asarray(table[:, i]) for i in cols])


def _same(a, b):
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            and a[2] == b[2])


@pytest.mark.parametrize("flags", [0, 1, 2, 3])
def test_plain_matches_jax_scan(flags):
    lv, Ts, mu, sd, Ks, epb = _batch(6, 120, 240, seed=flags)
    table = ph.make_transitions(epb)
    _, traces = profile_hmm_viterbi(lv, Ts, mu, sd, np.log(sd), Ks, epb,
                                    flags=flags, with_trace=True,
                                    trans=_jax_trans(table))
    ref = viterbi_backtrack(np.asarray(traces), Ts, Ks)
    got = pv.profile_hmm_viterbi_align(lv, Ts, mu, sd, Ks, epb, flags,
                                       device="cpu")
    assert all(_same(r, g) for r, g in zip(ref, got))
    # trace cells, packed as the kernels pack them
    jt = np.asarray(traces)                         # [T, B, K, (K, B, M)]
    packed = (jt[..., 2] | ((jt[..., 1] == 2).astype(np.uint8) << 3)
              | (jt[..., 0] << 4)).transpose(1, 0, 2)
    x = pv.prepare_viterbi_inputs(lv, Ts, mu, sd, Ks, epb, flags,
                                  device="cpu")
    mine = pv.viterbi_fill(x["levels"], x["n_events"], x["mu"], x["sigma"],
                           x["c"], x["n_kmers"], x["trans"],
                           x["clips"]).numpy()
    for b in range(len(Ts)):
        np.testing.assert_array_equal(mine[b, :Ts[b], :Ks[b]],
                                      packed[b, :Ts[b], :Ks[b]])


def test_mixed_flags_one_batch():
    lv, Ts, mu, sd, Ks, epb = _batch(8, 100, 200, seed=9)
    flags = np.array([0, 1, 2, 3, 3, 2, 1, 0], np.int32)
    got = pv.profile_hmm_viterbi_align(lv, Ts, mu, sd, Ks, epb, flags,
                                       device="cpu")
    table = ph.make_transitions(epb)
    for b in range(8):
        _, traces = profile_hmm_viterbi(
            lv[b:b + 1], Ts[b:b + 1], mu[b:b + 1], sd[b:b + 1],
            np.log(sd[b:b + 1]), Ks[b:b + 1], epb[b:b + 1],
            flags=int(flags[b]), with_trace=True,
            trans=_jax_trans(table[b:b + 1]))
        ref = viterbi_backtrack(np.asarray(traces), Ts[b:b + 1], Ks[b:b + 1])
        assert _same(ref[0], got[b])


@pytest.mark.parametrize("n", [1, 2, 5, 31, 32, 33, 100, 128, 160])
def test_kchain_grouping_is_associative_scans(n):
    """The K chain is bit-identical to jax.lax.associative_scan's
    max-plus recurrence, for odd and even widths."""
    rng = np.random.default_rng(n)
    c = rng.normal(-200, 30, (3, n)).astype(np.float32)
    c[:, ::7] = -np.inf
    lp_kk = np.array([np.log(0.3), np.log(0.25), np.log(0.7)], np.float32)

    def combine(x, y):
        return x[0] + y[0], jnp.maximum(x[1] + y[0], y[1])

    a = jnp.broadcast_to(jnp.asarray(lp_kk)[:, None], c.shape)
    _, ref = jax.lax.associative_scan(combine, (a, jnp.asarray(c)), axis=1)
    got = ph.kstate_chain_max(torch.from_numpy(c), torch.from_numpy(lp_kk))
    np.testing.assert_array_equal(np.asarray(ref).view(np.int32),
                                  got.numpy().view(np.int32))


def test_plain_matches_pallas_interpret():
    """At one small shape, against the Pallas Viterbi in interpret mode.
    Its closed-form K chain may resolve exactly tied optima differently
    (ROADMAP: known divergences); this data has no such ties, so the
    tracebacks must agree."""
    from nanopolish_tpu.ops.pallas_profile_hmm import profile_hmm_viterbi_pallas
    lv, Ts, mu, sd, Ks, epb = _batch(4, 100, 200, seed=21)
    ref = profile_hmm_viterbi_pallas(lv, Ts, mu, sd, np.log(sd), Ks, epb, 3)
    got = pv.profile_hmm_viterbi_align(lv, Ts, mu, sd, Ks, epb, 3,
                                       device="cpu")
    n_tie_diff = sum(not _same(r, g) for r, g in zip(ref, got))
    print(f"segments differing from the Pallas kernel: {n_tie_diff}")
    assert n_tie_diff == 0


@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_lane_schedule_matches_kstate_chain_max(R):
    """The warp kernels' in-place lane schedule of the K chain (R kmers
    per lane, register levels then lane levels; tests/kchain_lanes.py)
    gives kstate_chain_max's values bit for bit, ties and -inf included."""
    rng = np.random.default_rng(100 + R)
    c, lp_kk = chain_inputs(rng, 8, 32 * R)

    def op(x, y):
        return np.where(x > y, x, y)    # npt_max

    got = lane_schedule_chain(c, lp_kk, R, op)
    ref = ph.kstate_chain_max(torch.from_numpy(c),
                              torch.from_numpy(lp_kk)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # the inputs do hold exact ties: c[k] == K[k-1] + lp_kk, both finite
    tie = (c[:, 1:] == ref[:, :-1] + lp_kk[:, None]) & np.isfinite(c[:, 1:])
    assert tie.sum() > 0


@pytest.mark.parametrize("kp", [32, 64, 128, 256, 512, 1024])
def test_row_layout(kp):
    mode, kpl = pv.row_layout(kp)
    if kp <= 256:
        assert (mode, kpl) == ("warp", kp // 32) and kpl in (1, 2, 4, 8)
    else:
        assert (mode, kpl) == ("block", 0)


@pytest.mark.parametrize("kp", [2048, 4096, 32768, 1 << 20])
def test_row_layout_wide(kp):
    """Past 1,024 kmers the wide row, whose geometry depends on the batch
    too (wide_layout): kp = kmers a thread x threads x CTAs a segment, and
    its rows go to global scratch once a CTA's 13 bytes a kmer (12 for the
    Forward) and the fixed 1,024 bytes pass a block's 227 KB."""
    assert pv.row_layout(kp) == ("wide", None)
    for B in (1, 2, 68, 4096):
        for trace in (True, False):
            lay = pv.wide_layout(kp, B, trace)
            n = kp // lay.cluster
            assert lay.per_thread * (lay.threads - 32) * lay.cluster == kp
            row_bytes = n * (13 if trace else 12)
            shared = pv.WIDE_FIXED_BYTES + row_bytes <= pv.SMEM_BLOCK_MAX
            assert lay.rows == ("shared" if shared else "scratch")
            assert lay.smem == pv.WIDE_FIXED_BYTES + (row_bytes if shared
                                                      else 0)
            assert lay.scratch == (0 if shared else lay.cluster * row_bytes)
            scratch = pv.wide_scratch(lay, B, torch.device("meta"))
            if shared:
                assert scratch is None
            else:
                assert scratch.dtype == torch.uint8
                assert scratch.numel() == B * lay.cluster * row_bytes


# (kp, B, trace) -> (threads a CTA with the tree warp, kmers a thread,
# CTAs a segment, rows, shared bytes a CTA, scratch bytes a segment) on a
# card of 132 SMs
WIDE_GEOMETRIES = [
    ((2048, 8, True), (288, 1, 8, "shared", 1024 + 13 * 256, 0)),
    ((2048, 132, False), (544, 4, 1, "shared", 1024 + 12 * 2048, 0)),
    ((4096, 1, False), (288, 1, 16, "shared", 1024 + 12 * 256, 0)),
    ((8192, 1, False), (544, 1, 16, "shared", 1024 + 12 * 512, 0)),
    ((8192, 4, False), (544, 1, 16, "shared", 1024 + 12 * 512, 0)),
    ((8192, 8, True), (544, 1, 16, "shared", 1024 + 13 * 512, 0)),
    ((8192, 9, True), (544, 2, 8, "shared", 1024 + 13 * 1024, 0)),
    ((8192, 17, False), (544, 4, 4, "shared", 1024 + 12 * 2048, 0)),
    ((8192, 64, False), (544, 8, 2, "shared", 1024 + 12 * 4096, 0)),
    ((8192, 67, False), (544, 16, 1, "shared", 1024 + 12 * 8192, 0)),
    ((16384, 68, True), (544, 32, 1, "shared", 1024 + 13 * 16384, 0)),
    ((32768, 68, True), (544, 64, 1, "scratch", 1024, 13 * 32768)),
    ((32768, 68, False), (544, 64, 1, "scratch", 1024, 12 * 32768)),
    ((32768, 4, True), (544, 4, 16, "shared", 1024 + 13 * 2048, 0)),
    ((131072, 2, True), (544, 16, 16, "shared", 1024 + 13 * 8192, 0)),
    ((524288, 1, False), (544, 64, 16, "scratch", 1024, 12 * 524288)),
]


@pytest.mark.parametrize("key,want", WIDE_GEOMETRIES)
def test_wide_layout_geometry(key, want):
    """The wide row's launch geometry for each kmer width and batch: the
    largest cluster (up to 16) that keeps every CTA of the launch on the
    card at once with at least 256 kmers a CTA, then up to 512 kmer
    threads a CTA beside its tree warp; the rows in shared memory while
    they fit."""
    assert tuple(pv.wide_layout(*key)) == want


@pytest.mark.parametrize("n_sms", [1, 66, 114, 132])
def test_wide_layout_fills_the_card_once(n_sms):
    """Every wide geometry multiplies out to kp, keeps B x cluster CTAs
    within the card's SMs (or one CTA a segment), and takes the largest
    such cluster."""
    for kp in (2048, 4096, 8192, 65536, 1 << 20):
        for B in (1, 2, 3, 4, 7, 16, 33, 64, 65, 132, 1000):
            lay = pv.wide_layout(kp, B, True, n_sms)
            assert lay.per_thread * (lay.threads - 32) * lay.cluster == kp
            assert lay.cluster == 1 or B * lay.cluster <= n_sms
            assert kp // lay.cluster >= pv.WIDE_MIN_CTA_KMERS
            bigger = 2 * lay.cluster
            assert (bigger > pv.WIDE_MAX_CLUSTER or B * bigger > n_sms
                    or kp // bigger < pv.WIDE_MIN_CTA_KMERS)


@pytest.mark.parametrize("kp", [32, 1024, 3000])
def test_wide_layout_rejects_other_widths(kp):
    with pytest.raises(ValueError, match="wide-row width"):
        pv.wide_layout(kp, 1, True)


@pytest.mark.parametrize("kp,B", [(256, 4), (1024, 4), (2048, 8), (8192, 4),
                                  (8192, 64), (32768, 68)])
def test_viterbi_fill_launch_geometry(monkeypatch, kp, B):
    """viterbi_fill hands the kernel the kmer width, kpl, threads a CTA
    and CTAs a segment of row_layout / wide_layout (on the card's SMs),
    and a scratch buffer exactly when the rows are in scratch."""
    from nanopolish_tpu_torch.utils import cuda_build
    calls = []
    monkeypatch.setattr(cuda_build, "require_cuda", lambda t: None)
    monkeypatch.setattr(cuda_build, "launch",
                        lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(cuda_build, "count_launch", lambda name: None)
    monkeypatch.setattr(pv, "card_sms", lambda dev: 132)
    scratches = []
    wide_scratch = pv.wide_scratch
    monkeypatch.setattr(pv, "wide_scratch", lambda lay, n, dev: scratches.
                        append(wide_scratch(lay, n, dev)) or scratches[-1])
    meta = torch.device("meta")
    T = 5
    f32, i32 = torch.float32, torch.int32
    args = [torch.empty((B, T), dtype=f32, device=meta),
            torch.empty(B, dtype=i32, device=meta)]
    args += [torch.empty((B, kp), dtype=f32, device=meta) for _ in range(3)]
    args += [torch.empty(B, dtype=i32, device=meta),
             torch.empty((B, 8), dtype=f32, device=meta),
             torch.empty((B, 2), dtype=torch.uint8, device=meta)]
    pv.viterbi_fill(*args)
    (name, a), = calls
    assert name == "viterbi_fill" and a[1] == T and a[5] == kp
    mode, kpl = pv.row_layout(kp)
    if mode == "wide":
        lay = pv.wide_layout(kp, B, True)
        assert a[6:9] == (lay.per_thread, lay.threads, lay.cluster)
        (scratch,) = scratches
        assert (scratch is None) == (lay.rows == "shared")
        if scratch is not None:
            assert scratch.numel() == B * lay.scratch
    else:
        assert a[6:9] == (kpl, 0, 0) and a[-1] is None and not scratches


@pytest.mark.parametrize("kp", [0, 16, 48, 100, 384])
def test_row_layout_rejects_other_widths(kp):
    with pytest.raises(ValueError, match="power of two"):
        pv.row_layout(kp)


@pytest.mark.parametrize("K,T,flags", [(1100, 500, 3), (1100, 500, 0),
                                         (20000, 40, 3), (3000, 150, 1),
                                         (12000, 40, 2)])
def test_wide_segment_matches_jax_scan(K, T, flags):
    """A 500-event segment of 1,100 kmers (the wide row at 2,048 on the
    card) and one of 20,000 kmers (width 32,768: its rows in global
    scratch on the card when the batch keeps one CTA a segment) align
    exactly as the JAX scan aligns them; so do segments at 4,096 kmers
    (two warps a CTA of eight) and 16,384 (the widest row one CTA holds
    in shared memory), where wide_layout's geometry changes."""
    from nanopolish_tpu.alignment import segments as jseg
    from nanopolish_tpu_torch.alignment import segments as tseg
    lv, Ts, mu, sd, Ks, epb = _batch(1, K + 1, T + 1, seed=K + flags)
    lv, mu, sd = lv[0, :T], mu[0, :K], sd[0, :K]
    want = jseg.viterbi_segments([jseg.HMMSegment(lv, mu, sd,
                                                  float(epb[0]), flags)])
    got = tseg.viterbi_segments([tseg.HMMSegment(lv, mu, sd, float(epb[0]),
                                                 flags)], device="cpu")
    assert _same(want[0], got[0]) and len(got[0][0]) > 0


def test_path_cells_round_trip():
    """The widened path cells (event << 32 | kmer << 2 | state, int64)
    carry event and kmer indices far past the old 19- and 10-bit fields."""
    ev = np.array([0, 1, 524288, 3_000_000, (1 << 31) - 1], np.int64)
    km = np.array([0, 1023, 1024, 700_000, ph.MAX_KMERS - 1], np.int64)
    st = np.array([2, 1, 0, 2, 1], np.int64)
    cells = (ev << ph.PATH_EVENT_SHIFT) | (km << ph.PATH_KMER_SHIFT) | st
    path = np.zeros((1, 1 + len(ev)), np.int64)
    path[0, 0] = len(ev)
    path[0, 1:] = cells[::-1]              # traceback order
    evs, kms, states = ph.paths_to_segments(path)[0]
    np.testing.assert_array_equal(evs, ev)
    np.testing.assert_array_equal(kms, km)
    assert states == "MBKMB"
    assert ph.MAX_KMERS >= 1 << 30


@pytest.mark.parametrize("kp", [32, 64, 128])
def test_bucket_padding_bit_identical(kp):
    """viterbi_fill_plain's trace cells in the live event rows and the
    first kp kmer columns are identical at width kp and at 2 kp: the K
    chain's tree value at k depends on elements <= k only, whatever the
    width (the warp and block kernels' rows rely on it)."""
    lv, Ts, mu, sd, Ks, epb = _batch(6, kp, 2 * kp + 20, seed=kp)
    Ks[0] = kp - 1
    Ts[1] = 1
    flags = np.arange(6, dtype=np.int32) % 4
    x1 = pv.prepare_viterbi_inputs(lv, Ts, mu, sd, Ks, epb, flags,
                                   device="cpu")
    x2 = pv.prepare_viterbi_inputs(
        lv, Ts, np.pad(mu, ((0, 0), (0, kp))),
        np.pad(sd, ((0, 0), (0, kp)), constant_values=1.0), Ks, epb, flags,
        device="cpu")
    assert x1["mu"].shape[1] == kp and x2["mu"].shape[1] == 2 * kp
    names = ("levels", "n_events", "mu", "sigma", "c", "n_kmers", "trans",
             "clips")
    narrow = ph.viterbi_fill_plain(*[x1[k] for k in names]).numpy()
    wide = ph.viterbi_fill_plain(*[x2[k] for k in names]).numpy()
    for b in range(6):
        np.testing.assert_array_equal(narrow[b, :Ts[b], :kp],
                                      wide[b, :Ts[b], :kp])


@pytest.mark.parametrize("n,kp", [(1, 32), (105, 128), (1024, 1024),
                                  (1025, 2048), (1100, 2048),
                                  (20000, 32768), (100_000, 131072)])
def test_kmer_width_has_no_ceiling(n, kp):
    assert pv.kmer_width(n) == kp


@pytest.mark.parametrize("R", [1, 2])
def test_wide_lane_schedule_matches_kstate_chain(R):
    """The wide row's K chain (csrc/profile_hmm_wide.cuh) at the train
    step's geometry: R kmers a thread, 1,024 threads a CTA, a cluster of
    8 CTAs (tests/kchain_lanes.py wide_schedule_chain), gives
    kstate_chain_max's values bit for bit."""
    rng = np.random.default_rng(7 + R)
    c, lp_kk = chain_inputs(rng, 3, 8 * 1024 * R)

    def op(x, y):
        return np.where(x > y, x, y)    # npt_max

    got = wide_schedule_chain(c, lp_kk, R, 1024, 8, op)
    ref = ph.kstate_chain_max(torch.from_numpy(c),
                              torch.from_numpy(lp_kk)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("J,nt,C", [(1, 32, 1), (1, 64, 2), (2, 64, 4),
                                    (4, 32, 8), (1, 256, 8), (8, 64, 1),
                                    (16, 32, 2), (4, 256, 4)])
def test_wide_schedule_matches_kstate_chain_max(J, nt, C):
    """The wide row's tiers (J kmers a thread, nt threads a CTA, C CTAs a
    segment: the in-thread levels, a warp's lanes, warp 0 over the warps'
    totals, every CTA over the cluster's totals, then the down-sweeps with
    the prefix of the tier below) give kstate_chain_max's values bit for
    bit, exact ties and -inf runs included, at every geometry shape
    wide_layout picks."""
    rng = np.random.default_rng(J * 1000 + nt + C)
    c, lp_kk = chain_inputs(rng, 6, J * nt * C)

    def op(x, y):
        return np.where(x > y, x, y)    # npt_max

    got = wide_schedule_chain(c, lp_kk, J, nt, C, op)
    ref = ph.kstate_chain_max(torch.from_numpy(c),
                              torch.from_numpy(lp_kk)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    tie = (c[:, 1:] == ref[:, :-1] + lp_kk[:, None]) & np.isfinite(c[:, 1:])
    assert tie.sum() > 0


def _fill_plain(lv, Ts, mu, sd, Ks, epb, flags):
    x = pv.prepare_viterbi_inputs(lv, Ts, mu, sd, Ks, epb, flags,
                                  device="cpu")
    return x, pv.viterbi_fill(x["levels"], x["n_events"], x["mu"],
                              x["sigma"], x["c"], x["n_kmers"], x["trans"],
                              x["clips"])


def test_backtrack_tile_constants_match_kernel():
    """backtrack_tile's tile size is the kernel's TILE_BYTES, every width's
    tile fits it with a window of 16-byte groups, and the model decodes
    with the kernel's MOVES."""
    import os
    src = open(os.path.join(os.path.dirname(pv.__file__), "..", "csrc",
                            "viterbi_backtrack.cu")).read()
    assert f"constexpr int TILE_BYTES = {pv.BT_TILE_BYTES};" in src
    assert f"constexpr unsigned MOVES = {hex(MOVES)}u;" in src
    for kp in (32, 64, 128, 256, 512, 1024, 2048, 32768):
        rows, window = pv.backtrack_tile(kp)
        assert window == min(kp, pv.BT_WINDOW_MAX) and window % 16 == 0
        assert rows * window == pv.BT_TILE_BYTES and rows >= 32


def test_moves_decode_matches_reference():
    """The kernel's decode (a nibble of MOVES picked by the state's move
    field) gives the reference's next state, kmer step and soft-clip stop
    for every state and every trace byte."""
    from tests.backtrack_tiles import FIELD
    for st in (ph.PSR9_KMER_SKIP, ph.PSR9_BAD_EVENT, ph.PSR9_MATCH):
        sh, msk, msh = FIELD[st]
        for byte in range(256):
            if st == ph.PSR9_MATCH:
                mv = byte & 7
            elif st == ph.PSR9_BAD_EVENT:
                mv = ph.HMT_FROM_SAME_B if (byte >> 3) & 1 else \
                    ph.HMT_FROM_SAME_M
            else:
                mv = (byte >> 4) & 7
            nst = ph.PSR9_MATCH if mv in (ph.HMT_FROM_SAME_M,
                                          ph.HMT_FROM_PREV_M) else \
                ph.PSR9_BAD_EVENT if mv in (ph.HMT_FROM_SAME_B,
                                            ph.HMT_FROM_PREV_B) else \
                ph.PSR9_KMER_SKIP
            dki = mv in (ph.HMT_FROM_PREV_M, ph.HMT_FROM_PREV_B,
                         ph.HMT_FROM_PREV_K)
            info = (MOVES >> (((byte >> sh) & msk) << msh)) & 15
            assert bool(info & 8) == (mv == ph.HMT_FROM_SOFT), (st, byte)
            if mv != ph.HMT_FROM_SOFT:
                assert (info & 3, (info >> 2) & 1) == (nst, dki), (st, byte)


def test_tiled_walk_eventalign_segments():
    """Eventalign-shaped segments (95-115 kmers, 200-260 events, width
    128): the staged walk (tests/backtrack_tiles.py) gives the plain
    traceback's paths, its window is the whole row, so no refill is ever
    forced, and a walk stages a tile per 64 rows."""
    rng = np.random.default_rng(5)
    B = 8
    nk = rng.integers(95, 116, B)
    nev = rng.integers(200, 261, B)
    lv, Ts, mu, sd, Ks, epb = _batch(B, 116, 261, seed=5)
    Ks[:], Ts[:] = nk, nev
    x, tr = _fill_plain(lv, Ts, mu, sd, Ks, epb, np.arange(B) % 4)
    assert tr.shape[2] == 128
    ref = ph.viterbi_backtrack_plain(tr, x["n_events"], x["n_kmers"]).numpy()
    got, staged, forced = tiled_paths(tr.numpy(), Ts, Ks,
                                      *pv.backtrack_tile(128))
    np.testing.assert_array_equal(got, ref)
    assert (ref[:, 0] > 200).all() and not forced.any()
    assert (staged <= -(-Ts // 64) + 1).all()


@pytest.mark.parametrize("kp,B,T", [(32, 6, 84), (64, 6, 148),
                                    (128, 6, 276), (256, 4, 300),
                                    (512, 4, 300), (1024, 3, 300),
                                    (2048, 2, 48)])
def test_tiled_walk_matches_plain(kp, B, T):
    """Every row layout's width (warp 32-256, block 512-1,024, wide 2,048):
    the staged walk equals viterbi_backtrack_plain, with one segment of
    one event and one of none; past 1,024 kmers with a few dozen events
    the K-state runs leave the 256-kmer window."""
    lv, Ts, mu, sd, Ks, epb = _batch(B, kp, T, seed=kp)
    Ks[0] = kp - 1
    Ts[1] = 1
    if kp == 2048:
        Ks[:] = [1100, 1500]
    else:
        Ts[2] = 0
    x, tr = _fill_plain(lv, Ts, mu, sd, Ks, epb, np.arange(B) % 4)
    assert tr.shape[2] == kp
    ref = ph.viterbi_backtrack_plain(tr, x["n_events"], x["n_kmers"]).numpy()
    got, staged, forced = tiled_paths(tr.numpy(), Ts, Ks,
                                      *pv.backtrack_tile(kp))
    np.testing.assert_array_equal(got, ref)
    assert ref[1, 0] >= 1 and staged[1] == 1
    if kp == 2048:
        assert forced.sum() > 0
    else:
        assert ref[2, 0] == 0 and staged[2] == 0


def test_tiled_walk_long_kmer_skip():
    """A hand-made trace whose walk skips 600 kmers in one row (a K-state
    run across three 256-kmer windows) and then steps down the rows: the
    staged walk follows it as the plain traceback does, staging the
    window anew twice."""
    T, KP = 70, 1024
    tr = np.zeros((1, T, KP), np.uint8)    # M from the same kmer, row - 1
    tr[0, 69, 900] = ph.HMT_FROM_PREV_K      # M at (69, 900) from K at 899
    tr[0, 68, 301:900] = ph.HMT_FROM_PREV_K << 4    # K from K, kmer - 1
    tr[0, 68, 300] = ph.HMT_FROM_PREV_M << 4        # K at 300 from M at 299
    nev, nk = np.array([70], np.int32), np.array([901], np.int32)
    ref = ph.viterbi_backtrack_plain(torch.from_numpy(tr),
                                     torch.from_numpy(nev),
                                     torch.from_numpy(nk)).numpy()
    got, staged, forced = tiled_paths(tr, nev, nk, *pv.backtrack_tile(KP))
    np.testing.assert_array_equal(got, ref)
    assert forced[0] >= 2 and ref[0, 0] == 1 + 600 + 69


def test_tiled_walk_jax_traces():
    """Traces from the JAX scan, packed as the kernels pack them: the
    staged walk's paths are the JAX path's tracebacks."""
    lv, Ts, mu, sd, Ks, epb = _batch(6, 120, 240, seed=3)
    table = ph.make_transitions(epb)
    _, traces = profile_hmm_viterbi(lv, Ts, mu, sd, np.log(sd), Ks, epb,
                                    flags=3, with_trace=True,
                                    trans=_jax_trans(table))
    ref = viterbi_backtrack(np.asarray(traces), Ts, Ks)
    jt = np.asarray(traces)                         # [T, B, K, (K, B, M)]
    packed = (jt[..., 2] | ((jt[..., 1] == 2).astype(np.uint8) << 3)
              | (jt[..., 0] << 4)).transpose(1, 0, 2)
    kp = pv.kmer_width(packed.shape[2])
    wide = np.zeros(packed.shape[:2] + (kp,), np.uint8)
    wide[:, :, :packed.shape[2]] = packed
    got, _, _ = tiled_paths(wide, Ts, Ks, *pv.backtrack_tile(kp))
    assert all(_same(r, g) for r, g in zip(ref, ph.paths_to_segments(got)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA Viterbi kernels have no "
                    "CPU mode (their plain version is tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kp", [32, 64, 128, 256, 512, 1024, 2048, 32768])
def test_kernels_match_plain_on_gpu(cuda_device, kp):
    """Every row layout (warp kernel at R = 1, 2, 4, 8; block kernel at
    512 and 1,024; wide row at 2,048, and at 32,768 with its rows in
    global scratch; the backtrack's whole-row and 256-kmer windows):
    n_kmers not a multiple of 32 R, all four clip flags, one segment with
    a single event."""
    B, T = (16, 2 * kp + 20) if kp <= 512 else (4, 48)
    if kp == 1024:
        B, T = 4, 300
    lv, Ts, mu, sd, Ks, epb = _batch(B, kp, T, seed=kp)
    Ks[0] = kp - 1
    Ts[1] = 1
    flags = np.arange(B, dtype=np.int32) % 4
    x = pv.prepare_viterbi_inputs(lv, Ts, mu, sd, Ks, epb, flags,
                                  device=cuda_device)
    assert x["mu"].shape[1] == kp
    args = (x["levels"], x["n_events"], x["mu"], x["sigma"], x["c"],
            x["n_kmers"], x["trans"], x["clips"])
    tk = pv.viterbi_fill(*args)
    tp = ph.viterbi_fill_plain(*args)
    for b in range(B):
        assert torch.equal(tk[b, :Ts[b], :Ks[b]], tp[b, :Ts[b], :Ks[b]])
    got = ph.paths_to_segments(
        pv.viterbi_backtrack(tk, x["n_events"], x["n_kmers"]).cpu().numpy())
    ref = ph.paths_to_segments(
        ph.viterbi_backtrack_plain(tp, x["n_events"], x["n_kmers"]).cpu().numpy())
    assert all(_same(r, g) for r, g in zip(ref, got))


@pytest.mark.cuda
@pytest.mark.parametrize("kp,B,T", [(2048, 8, 60), (8192, 1, 40),
                                    (8192, 4, 40), (8192, 64, 12),
                                    (16384, 68, 8), (32768, 68, 8)])
def test_wide_geometries_match_plain_on_gpu(cuda_device, kp, B, T):
    """The wide row at each kind of wide_layout geometry (clusters of 8, 2
    and 1 CTA a segment, rows in shared memory and in scratch), trace
    cells bit for bit."""
    lv, Ts, mu, sd, Ks, epb = _batch(B, kp, T, seed=kp + B)
    Ks[0] = kp - 1
    flags = np.arange(B, dtype=np.int32) % 4
    x = pv.prepare_viterbi_inputs(lv, Ts, mu, sd, Ks, epb, flags,
                                  device=cuda_device)
    assert x["mu"].shape[1] == kp
    names = ("levels", "n_events", "mu", "sigma", "c", "n_kmers", "trans",
             "clips")
    got = pv.viterbi_fill(*[x[k] for k in names])
    ref = ph.viterbi_fill_plain(*[x[k] for k in names])
    for b in range(B):
        assert torch.equal(got[b, :Ts[b]], ref[b, :Ts[b]])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32])
def test_backtrack_batches_match_plain_on_gpu(cuda_device, B):
    """Eventalign-shaped segments in a one-segment launch and in a
    32-segment wavefront launch (eight blocks of four warps): the kernel's
    paths equal the plain traceback's entry for entry."""
    rng = np.random.default_rng(B)
    lv, Ts, mu, sd, Ks, epb = _batch(B, 116, 261, seed=B)
    Ks[:] = rng.integers(95, 116, B)
    Ts[:] = rng.integers(200, 261, B)
    x = pv.prepare_viterbi_inputs(lv, Ts, mu, sd, Ks, epb,
                                  np.arange(B, dtype=np.int32) % 4,
                                  device=cuda_device)
    tr = pv.viterbi_fill(x["levels"], x["n_events"], x["mu"], x["sigma"],
                         x["c"], x["n_kmers"], x["trans"], x["clips"])
    got = pv.viterbi_backtrack(tr, x["n_events"], x["n_kmers"]).cpu()
    ref = ph.viterbi_backtrack_plain(tr, x["n_events"], x["n_kmers"]).cpu()
    assert torch.equal(got[:, 0], ref[:, 0])
    for b in range(B):
        n = int(ref[b, 0])
        assert torch.equal(got[b, 1:1 + n], ref[b, 1:1 + n])
