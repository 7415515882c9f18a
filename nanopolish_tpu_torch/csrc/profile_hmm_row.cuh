// One profile-HMM event row, warp-synchronous: the row of
// csrc/viterbi_fill.cu, csrc/forward_fill.cu and csrc/forward_indexed.cu
// for kmer widths KP = W R, R = 1, 2, 4, 8 kmers per lane on a group of
// W = 32 lanes (one segment per warp), or R = 1 on W = 8 or 16 lanes
// (forward_indexed.cu's short windows: 32 / W segments per warp).
//
// A group of W lanes holds one segment's row.  Group lane l holds kmers
// l R ... l R + R - 1: their gaussians and the previous row's M, B and K
// scores, all in registers.  A kmer's k - 1 neighbour is the lane's own
// register, or for its first kmer lane l - 1's last one (npt_shfl_prev;
// the two shuffles of a row's new M and B and the K chain's last one also
// serve the next row).  Every shuffle takes the width argument W, so the
// groups of a warp never read each other.  No shared memory and no
// barriers: the warp's lanes run in step, so a row costs its dependent
// arithmetic and a few shuffles, not 2 log2(KP) + 3 block barriers and
// round trips through shared memory.
//
// The K-skip chain K[k] = op(c[k], K[k-1] + lp_kk) runs on
// jax.lax.associative_scan's pairwise tree, in the grouping of the block
// kernels' shared-memory tree (npt_forward_block, viterbi_fill.cu's block
// kernel) and of ops/profile_hmm.py _kstate_chain, in place: level l's
// element j sits at kmer position (j + 1) 2^l - 1.  Levels 0 ... log2 R - 1
// combine registers inside a lane; levels log2 R ... log2 KP - 1 combine the
// lanes' last registers with __shfl_up_sync at lane distance 2^l / R; the
// down-sweep mirrors it.  Every element of level l carries
// a = lp_kk * 2^l (doubled on the way up, halved on the way down, both
// exact), so every K value, and every exact-tie trace decision of the
// Viterbi, is rounded as the block kernels and the plain versions round it.
// The tree of a W-lane group is the first W lanes of the 32-lane tree
// (a value at k depends on elements <= k only), so a segment's scores do
// not depend on the group width it is run at.
//
// The group loads its segment's event levels W at a time with one
// coalesced load, one chunk ahead, and broadcasts one per row with
// __shfl_sync, so no row waits on a dependent global load.  A lane's R
// emissions do not depend on the chain: each row computes the next row's,
// where its operation places them (Op::kEmitMidRow).
#pragma once

#include "forward_common.cuh"

// Segments (warps) per block of the warp kernels.  Each warp is a segment
// of its own, so this only sets how many share an SM's block slots: on an
// H100, 2 timed the same as 4 and 8 was slower for the Viterbi
// (PERF.md).
constexpr int NPT_ROW_WARPS = 4;

constexpr int NPT_FROM_SAME_M = 0, NPT_FROM_PREV_M = 1, NPT_FROM_SAME_B = 2,
              NPT_FROM_PREV_B = 3, NPT_FROM_PREV_K = 4, NPT_FROM_SOFT = 5;

// The Viterbi's operation: max, with trace decisions.  Its row is a chain
// of shuffles and cheap max-plus steps, so the next row's emissions (R
// IEEE divisions, whose slow-path checks are branches) go mid-row, in the
// shadow of the shuffles (faster on an H100 than at the row's end:
// tools/probe_hmm_rows.py, PERF.md).
struct NptMaxPlus {
    static constexpr bool kTrace = true;
    static constexpr bool kEmitMidRow = true;
    __device__ static __forceinline__ float op(float a, float b) {
        return npt_max(a, b);
    }
};

// The Forward's operation: log(e^a + e^b) as jnp.logaddexp evaluates it.
// Its row is issue-bound on the logaddexps; the next row's emissions go at
// the row's end (faster on an H100 than mid-row).
struct NptLogSum {
    static constexpr bool kTrace = false;
    static constexpr bool kEmitMidRow = false;
    __device__ static __forceinline__ float op(float a, float b) {
        return npt_logaddexp(a, b);
    }
};

// One lane's R kmers: gaussians, the M/B/K scores of the last row, that
// row's M/B/K of kmer l R - 1 (the lane below's last; -inf in lane 0), and
// the emissions of the row to come.
template <int R>
struct NptRowLane {
    float mu[R], sg[R], cc[R];
    float M[R], B[R], K[R];
    float Mq, Bq, Kq;
    float em[R];
};

template <int R>
__device__ __forceinline__ void npt_row_emissions(NptRowLane<R>& s,
                                                  float x) {
#pragma unroll
    for (int r = 0; r < R; ++r)
        s.em[r] = npt_log_normal(x, s.mu[r], s.sg[r], s.cc[r]);
}

// A segment's nev event levels, W per coalesced load of its group, one
// chunk ahead.
template <int W = 32>
struct NptRowLevels {
    const float* levb;
    int nev, gl;
    float cur, nxt;

    __device__ __forceinline__ float load(int i) const {
        return i + gl < nev ? __ldg(levb + i + gl) : 0.0f;
    }
    __device__ __forceinline__ NptRowLevels(const float* l, int n, int g)
            : levb(l), nev(n), gl(g) {
        cur = load(0);
        nxt = load(W);
    }
    // level i (0-based; past nev a level of 0 whose emissions go unused);
    // every lane of the warp calls it with the same i, in increasing order
    __device__ __forceinline__ float at(int i) {
        if (i > 0 && (i & (W - 1)) == 0) {
            cur = nxt;
            nxt = load(i + W);
        }
        return __shfl_sync(NPT_FULL_MASK, cur, i & (W - 1), W);
    }
};

// A lane's start once its gaussians are in place: every score -inf, the
// first row's emissions.
template <int R, int W>
__device__ __forceinline__ void npt_row_lane_start(NptRowLane<R>& s,
                                                   NptRowLevels<W>& lv) {
#pragma unroll
    for (int r = 0; r < R; ++r) s.M[r] = s.B[r] = s.K[r] = npt_neg_inf();
    s.Mq = s.Bq = s.Kq = npt_neg_inf();
    npt_row_emissions<R>(s, lv.at(0));
}

// A lane's start: kmers l R ... l R + R - 1 of the tables at mu/sig/cc
// (offset to the lane), every score -inf, the first row's emissions.
template <int R>
__device__ __forceinline__ void npt_row_lane_init(
        NptRowLane<R>& s, const float* __restrict__ mu,
        const float* __restrict__ sig, const float* __restrict__ cc,
        NptRowLevels<32>& lv) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
        s.mu[r] = __ldg(mu + r);
        s.sg[r] = __ldg(sig + r);
        s.cc[r] = __ldg(cc + r);
    }
    npt_row_lane_start<R, 32>(s, lv);
}

// The K chain on the lane layout: v holds group lane l's inputs
// c[l R + r] and leaves with K[l R + r].  Returns K[l R - 1] (-inf in
// group lane 0).
template <int R, class Op, int W = 32>
__device__ __forceinline__ float npt_row_kchain(float (&v)[R], float lp_kk,
                                                int lane) {
    float a = lp_kk;
    // up-sweep inside the lane: level l+1's element at r (r + 1 a multiple
    // of 2h, h = 2^l) = (level l's element at r - h, + a_l) (+) at r
#pragma unroll
    for (int h = 1; h < R; h <<= 1) {
#pragma unroll
        for (int r = 2 * h - 1; r < R; r += 2 * h)
            v[r] = Op::op(npt_add(v[r - h], a), v[r]);
        a = npt_add(a, a);
    }
    // up-sweep across lanes (levels log2 R ...): the lanes' last registers,
    // lane distance d = 2^l / R, as forward_indexed.cu's warp mode at R = 1
#pragma unroll
    for (int d = 1; d < W; d <<= 1) {
        const float u = __shfl_up_sync(NPT_FULL_MASK, v[R - 1], d, W);
        if (((lane + 1) & (2 * d - 1)) == 0)
            v[R - 1] = Op::op(npt_add(u, a), v[R - 1]);
        a = npt_add(a, a);
    }
    // down-sweep across lanes: level l's even element j > 0 (in lane
    // (j + 1) d - 1) = (level l+1's element j/2 - 1, d lanes below, + a_l)
    // (+) its up-sweep value; odd elements and element 0 keep theirs.  The
    // top level below the root (d = W / 2) has only elements 0 and 1.
    a = a * 0.5f;                        // exact: undoes the doubling
#pragma unroll
    for (int d = W / 4; d >= 1; d >>= 1) {
        a = a * 0.5f;
        const float u = __shfl_up_sync(NPT_FULL_MASK, v[R - 1], d, W);
        if (((lane + 1) & (2 * d - 1)) == d && lane + 1 >= 3 * d)
            v[R - 1] = Op::op(npt_add(u, a), v[R - 1]);
    }
    // every lane's last register is final: K[l R - 1] closes the lane's
    // first element of each level below
    const float prev = npt_shfl_prev<W>(v[R - 1], 1, lane);
    // down-sweep inside the lane: level l's elements at r + 1 = h, 3h, 5h
    // ... (h = 2^l) from the element h positions below; at r = h - 1 that
    // is K[l R - 1], and in lane 0 element 0, which keeps its value
#pragma unroll
    for (int h = R / 2; h >= 1; h >>= 1) {
        a = a * 0.5f;
#pragma unroll
        for (int r = h - 1; r < R; r += 2 * h) {
            if (r == h - 1) {
                if (lane > 0) v[r] = Op::op(npt_add(prev, a), v[r]);
            } else {
                v[r] = Op::op(npt_add(v[r - h], a), v[r]);
            }
        }
    }
    return prev;
}

// One event row t (1-based) of the group lane `lane`: updates s.M, s.B,
// s.K in place from s.em, and leaves the next row's emissions (level t of
// lv) in s.em.  For the Viterbi (Op::kTrace) tr[r] gets kmer l R + r's
// trace byte trM | trB << 3 | trK << 4.  The arithmetic, term order and
// tie rules are those of the block kernels (npt_forward_block;
// viterbi_fill.cu).
template <int R, class Op, int W = 32>
__device__ __forceinline__ void npt_row(int t, int lane,
                                        const NptFwdParams& p,
                                        NptRowLane<R>& s, NptRowLevels<W>& lv,
                                        uint32_t (&tr)[R]) {
    const float NEG = npt_neg_inf();
    const float x_next = lv.at(t);

    // soft-clip entry into the first kmer (r9.inl:200-227)
    const float soft = (lane == 0 && (p.pre_clip || t == 1))
        ? npt_flank((float)(t - 1), p.flank0, p.clip_base, p.clip_step)
        : NEG;

    float Mn[R], Bn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float M = s.M[r], Bv = s.B[r];
        const float x0 = npt_add(p.lp_mm_self, M);
        const float x1 = npt_add(p.lp_mm_next, r > 0 ? s.M[r - 1] : s.Mq);
        const float x2 = npt_add(p.lp_b3, Bv);
        const float x3 = npt_add(p.lp_b3, r > 0 ? s.B[r - 1] : s.Bq);
        const float x4 = npt_add(p.lp_km, r > 0 ? s.K[r - 1] : s.Kq);
        const float x5 = r == 0 ? soft : NEG;
        const float b0 = npt_add(p.lp_mb, M);
        const float b2 = npt_add(p.lp_bb, Bv);
        float m_in;
        if constexpr (Op::kTrace) {
            m_in = npt_max(npt_max(npt_max(x0, x1), npt_max(x2, x3)),
                           npt_max(x4, x5));
            // the LAST equal index wins (r9.inl:140-146)
            uint32_t trM = NPT_FROM_SAME_M;
            if (x1 == m_in) trM = NPT_FROM_PREV_M;
            if (x2 == m_in) trM = NPT_FROM_SAME_B;
            if (x3 == m_in) trM = NPT_FROM_PREV_B;
            if (x4 == m_in) trM = NPT_FROM_PREV_K;
            if (x5 == m_in) trM = NPT_FROM_SOFT;
            Bn[r] = npt_max(b0, b2);
            tr[r] = trM | ((b2 == Bn[r] ? 1u : 0u) << 3);
        } else {
            m_in = Op::op(x0, x1);
            m_in = Op::op(m_in, x2);
            m_in = Op::op(m_in, x3);
            m_in = Op::op(m_in, x4);
            // logaddexp(m, -inf) is m + 0.0f bit for bit (finite m: max m,
            // log1pf(expf(-inf)) = 0; m = -inf: the NaN branch, -inf), so
            // only the first kmer of a lane, where lane 0 may carry the
            // soft-clip term, needs the whole operation
            m_in = r == 0 ? Op::op(m_in, x5) : npt_add(m_in, 0.0f);
            Bn[r] = Op::op(b0, b2);
        }
        Mn[r] = npt_add(m_in, s.em[r]);
    }

    // the K chain's inputs: this row's M and B of kmer k - 1 (the lane
    // below's last, also the next row's Mq and Bq)
    s.Mq = npt_shfl_prev<W>(Mn[R - 1], 1, lane);
    s.Bq = npt_shfl_prev<W>(Bn[R - 1], 1, lane);
    if constexpr (Op::kEmitMidRow) npt_row_emissions<R>(s, x_next);
    float cB[R], v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float cM = npt_add(p.lp_mk, r > 0 ? Mn[r - 1] : s.Mq);
        cB[r] = npt_add(p.lp_b3, r > 0 ? Bn[r - 1] : s.Bq);
        v[r] = Op::op(cM, cB[r]);
    }
    s.Kq = npt_row_kchain<R, Op, W>(v, p.lp_kk, lane);

    if constexpr (Op::kTrace) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float kk_prev = npt_add(r > 0 ? v[r - 1] : s.Kq, p.lp_kk);
            uint32_t trK = NPT_FROM_PREV_M;
            if (cB[r] == v[r]) trK = NPT_FROM_PREV_B;
            if (kk_prev == v[r]) trK = NPT_FROM_PREV_K;
            tr[r] |= trK << 4;
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        s.M[r] = Mn[r];
        s.B[r] = Bn[r];
        s.K[r] = v[r];
    }
    if constexpr (!Op::kEmitMidRow) npt_row_emissions<R>(s, x_next);
}
