// The wide row of the profile-HMM fills: kmer widths KP above 1,024, for
// csrc/viterbi_fill.cu, csrc/forward_fill.cu and csrc/forward_indexed.cu.
//
// What bounds it on an H100: a Forward row of 8,192 kmers is ~2.5 M
// instructions (nine logaddexps a cell, ~35 instructions each), ~20k
// cycles of one SM's issue, and its K-skip chain is 2 log2 KP - 1
// dependent tree levels of ~250-350 cycles each (a logaddexp and a
// shuffle).  One block a segment, as in the train step's whole reads (4
// to 64 a launch), is issue-bound on one SM; a segment spread over a
// cluster of CTAs is bound by its chain.
//
// Geometry (ops/profile_hmm_viterbi.py wide_layout picks it from KP and
// the batch): a segment is a cluster of C CTAs (1 ... 16; above 8 a
// non-portable size), the most that keeps every CTA of the launch on the
// card at once with at least 256 kmers a CTA; CTA r holds kmers r n ...
// r n + n - 1 (n = KP / C) on nk kmer threads, thread th the J = n / nk
// kmers kb = r n + th J ... kb + J - 1, and one more warp, the tree warp,
// holds none.  tools/probe_hmm_rows.py --wide-cluster times the cluster
// sizes against each other (PERF.md §6).
//
// The previous row's M, B and K scores (and the Viterbi's trM | trB bits)
// live in a row buffer laid out [j][thread], so that a warp's accesses of
// its threads' j-th kmers are 32 consecutive words: shared memory when it
// fits beside the fixed part (NPT_WIDE_FIXED_BYTES), else the global
// scratch the wrapper allocates (coalesced in the same layout), so that no
// width that fits in memory is refused.  Only the owning thread reads a
// kmer's scores; a thread's first kmer takes its neighbour's from a
// register carried from the last row, and this row's from the lane below
// (__shfl_up_sync), the warp below (shared memory) or the CTA below (a
// tagged slot, below).  A group of U kmers of a thread (4, 2 or 1) goes
// through each loop at once, its loads first, so that their chains
// interleave.
//
// The K-skip chain runs on jax.lax.associative_scan's pairwise tree in the
// lanes' schedule of npt_row_kchain (profile_hmm_row.cuh), one tier at a
// time: levels 0 ... log2 J - 1 inside a thread, then the threads' last
// elements across the warp's lanes by shuffles, the warps' totals across
// the CTA by shuffles in the tree warp, and the CTAs' totals across the
// cluster, which every CTA's tree warp receives through distributed
// shared memory and sweeps itself.  The down-sweep mirrors it; a tier's
// first element of each level takes the final value at the end of the
// tier before it (the CTA, warp or thread below), as the flat tree does.
// Every element of level l carries a = lp_kk * 2^l, so every K value and
// every exact-tie trace decision is rounded as the plain versions round
// it (tests/kchain_lanes.py wide_schedule_chain is its NumPy model).
// Each combine is branch-free (computed, then selected) and the tree
// warp's levels are unrolled.
//
// A row costs three barriers of the CTA (this row's M and B written, the
// warps' totals written, the tree warp's results written) and, in a
// cluster, two hand-overs through tagged slots in distributed shared
// memory (the CTA below's last M and B; every CTA's total): one 8-byte
// store of a float and its row number, polled by the taker, with no
// barrier across the cluster in the row loop.  With one kmer a thread,
// the Forward folds the next row's first four M terms and its B in
// registers while the warp waits on this row's down-sweep, so the row's
// M waits on two logaddexps, not five.
#pragma once

#include "profile_hmm_row.cuh"

// a block's shared memory on sm_90 (227 KB)
constexpr size_t NPT_SMEM_BLOCK_MAX = 232448;
// kmer threads of a CTA (16 warps), and its threads with the tree warp
constexpr int NPT_WIDE_MAX_KMER_THREADS = 512;
constexpr int NPT_WIDE_MAX_THREADS = NPT_WIDE_MAX_KMER_THREADS + 32;
// a cluster of more than 8 CTAs is not portable: the launch asks for it
constexpr int NPT_WIDE_MAX_CLUSTER = 16;
static_assert(NPT_WIDE_MAX_KMER_THREADS <= 512 && NPT_WIDE_MAX_CLUSTER <= 16,
              "the fixed shared memory holds 16 warps' and 16 CTAs' slots");
// The wide row's fixed shared memory, ahead of the row buffer, for two
// rows each (by the row's parity): the tagged slots of the CTA below's
// last M and B (2 x 2 x 8 bytes) and of the cluster's CTA totals (2 x 16
// x 8 bytes), each warp's last M and B (2 x 17 each, slot 0 unused), and
// the warps' tree values (16) and results (17: slot 0 the CTA below's
// end); 1,024 bytes in all.
constexpr int NPT_WIDE_FIXED_FLOATS = 256;
constexpr size_t NPT_WIDE_FIXED_BYTES = NPT_WIDE_FIXED_FLOATS * sizeof(float);

// Bytes of one CTA's row buffer: n kmers' M, B and K, and the Viterbi's
// trace bits.
__host__ __device__ inline size_t npt_wide_row_bytes(int n, bool trace) {
    return (size_t)n * (trace ? 13 : 12);
}

// A CTA's dynamic shared memory.
__host__ __device__ inline size_t npt_wide_smem(int n, bool trace,
                                                bool rows_in_smem) {
    return NPT_WIDE_FIXED_BYTES +
           (rows_in_smem ? npt_wide_row_bytes(n, trace) : 0);
}

// Whether (KP, J, nt, C) is a wide-row geometry the kernels take: nt - 32
// kmer threads (a power of two, 32 ... NPT_WIDE_MAX_KMER_THREADS) and the
// tree warp.
__host__ __device__ inline bool npt_wide_geometry(int KP, int J, int nt,
                                                  int C) {
    const auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
    const int nk = nt - 32;
    return KP > 1024 && pow2(J) && pow2(nk) && nk >= 32 &&
           nk <= NPT_WIDE_MAX_KMER_THREADS && pow2(C) &&
           C <= NPT_WIDE_MAX_CLUSTER && (long long)J * nk * C == KP;
}

// kmer k's gaussian from a segment's flat [KP] tables
struct NptFlatGauss {
    const float* __restrict__ mu;
    const float* __restrict__ sg;
    const float* __restrict__ cc;
    __device__ __forceinline__ void operator()(int k, float& m, float& s,
                                               float& c) const {
        m = __ldg(mu + k);
        s = __ldg(sg + k);
        c = __ldg(cc + k);
    }
};

// ---- the cluster's distributed shared memory (sm_90) ----

__device__ __forceinline__ uint32_t npt_smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
// the shared::cluster address of this CTA's shared address a in CTA rank
__device__ __forceinline__ uint32_t npt_cluster_addr(uint32_t a, int rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r) : "r"(a), "r"(rank));
    return r;
}
// A tagged slot: one 8-byte word, the row number above a float's bits,
// stored whole by the CTA that hands the float over and polled by the
// one that takes it, so that the value and its row arrive together.
// A slot of each row parity; a CTA is never two rows ahead of another
// (every row waits for every CTA's total), so a slot is not written again
// before it is read.
__device__ __forceinline__ void npt_slot_put(uint32_t a, uint32_t tag,
                                             float x) {
    const uint64_t v = (uint64_t)tag << 32 | __float_as_uint(x);
    asm volatile("st.relaxed.cluster.shared::cluster.u64 [%0], %1;"
                 :: "r"(a), "l"(v) : "memory");
}
__device__ __forceinline__ float npt_slot_take(const uint64_t* slot,
                                               uint32_t tag) {
    uint64_t v;
    do {
        asm volatile("ld.relaxed.cluster.shared::cta.u64 %0, [%1];"
                     : "=l"(v) : "r"(npt_smem_addr(slot)) : "memory");
    } while ((uint32_t)(v >> 32) != tag);
    return __uint_as_float((uint32_t)v);
}
__device__ __forceinline__ void npt_cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\n\t"
                 "barrier.cluster.wait.acquire;" ::: "memory");
}

// Whether this CTA and thread hold kmer k of a segment on the wide row.
__device__ __forceinline__ bool npt_wide_owns(int k, int J, int C) {
    const int n = J * ((int)blockDim.x - 32);
    return (C > 1 ? (int)(blockIdx.x % C) : 0) == k / n &&
           (k % n) / J == (int)threadIdx.x;
}

// One combine of the K chain's tree, branch-free: op(src + a, own) where
// take, else own (a branch around a logaddexp would keep a warp's
// instructions from interleaving and cost a reconvergence every level).
template <class Op>
__device__ __forceinline__ float npt_wide_combine(bool take, float src,
                                                  float a, float own) {
    const float r = Op::op(npt_add(src, a), own);
    return take ? r : own;
}

// A kmer thread's cells in its CTA's row buffer (kmer j at j nk + th)
struct NptWideRows {
    float* M;
    float* B;
    float* K;
    uint8_t* TR;
    int nk, th;
    __device__ __forceinline__ int at(int j) const { return j * nk + th; }
};

// The Forward's first four M terms of kmer k folded, and its B, of the
// row to come, from this row's M and B of kmers k (M, B) and k - 1 (Mp,
// Bp); neither waits for the K chain.
__device__ __forceinline__ void npt_wide_fold(float M, float B, float Mp,
                                              float Bp, const NptFwdParams& p,
                                              float& m3, float& b_next) {
    m3 = npt_logaddexp(npt_add(p.lp_mm_self, M), npt_add(p.lp_mm_next, Mp));
    m3 = npt_logaddexp(m3, npt_add(p.lp_b3, B));
    m3 = npt_logaddexp(m3, npt_add(p.lp_b3, Bp));
    b_next = npt_logaddexp(npt_add(p.lp_mb, M), npt_add(p.lp_bb, B));
}

// One level of the K chain's tree inside the threads: the cnt elements
// r = r0 + s m (m < cnt) each take op(src + a, K[r]), src = K[r - h] or,
// for r == h - 1 in the down-sweep (first), K[kb - 1] (prev; kept as is
// in global kmer 0).  Four at a time, the loads first.
template <class Op>
__device__ __forceinline__ void npt_wide_level(const NptWideRows& R, int r0,
                                               int s, int h, int cnt,
                                               float a, bool first,
                                               float prev, bool has_prev) {
    for (int m0 = 0; m0 < cnt; m0 += 4) {
        float lo[4], hi[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int r = r0 + s * (m0 + u);
            if (m0 + u < cnt) {
                hi[u] = R.K[R.at(r)];
                lo[u] = first && r == h - 1 ? prev : R.K[R.at(r - h)];
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int r = r0 + s * (m0 + u);
            if (m0 + u < cnt && (has_prev || !(first && r == h - 1)))
                R.K[R.at(r)] = Op::op(npt_add(lo[u], a), hi[u]);
        }
    }
}

// One segment's fill on the wide row; every thread of the cluster calls
// it.  U kmers of a thread go through each loop at once (U divides J).
// levb: the segment's nev levels; gauss(k, mu, sigma, c): kmer k's
// gaussian; fixed: the NPT_WIDE_FIXED_FLOATS of shared memory; rows: this
// CTA's row buffer (npt_wide_row_bytes, shared or global).  Viterbi
// (Op::kTrace): writes trace byte trM | trB << 3 | trK << 4 of each live
// row to trb[(t - 1) KP + k].  Forward: returns the score in the thread
// that holds kmer `last` (npt_wide_owns).
template <int U, class Op, class Gauss>
__device__ float npt_wide_fill(const float* __restrict__ levb, int nev,
                               const Gauss& gauss, int J, int C, int last,
                               const NptFwdParams& p, float* fixed,
                               float* rows, uint8_t* __restrict__ trb) {
    const int nk = blockDim.x - 32;      // kmer threads; the last warp is
    const int th = threadIdx.x;          // the tree warp
    const bool tree = th >= nk;
    const int lane = th & 31, w = th >> 5, NW = nk >> 5;
    const int cr = C > 1 ? (int)(blockIdx.x % C) : 0;
    const int n = nk * J;
    const int KP = n * C;
    const int kb = cr * n + th * J;      // a kmer thread's first kmer
    const bool warp_pre = w > 0 || cr > 0;   // kmers before the warp's
    const float NEG = npt_neg_inf();
    uint64_t* HALO = reinterpret_cast<uint64_t*>(fixed);  // [2][2]: M, B
    uint64_t* TOT = HALO + 4;            // [2][16]: the CTAs' totals
    float* QM = fixed + 72;              // [2][17]: a warp's last M ...
    float* QB = QM + 34;                 // ... and B
    float* WT = QB + 34;                 // [16]: the warps' last tree values
    float* WF = WT + 16;                 // [17]: final K at each warp's end
    const NptWideRows R{rows, rows + n, rows + 2 * n,
                        reinterpret_cast<uint8_t*>(rows + 3 * n), nk, th};

    if (!tree)
        for (int j = 0; j < J; ++j)
            R.M[R.at(j)] = R.B[R.at(j)] = R.K[R.at(j)] = NEG;
    // One kmer a thread (U == 1), the Forward: the next row's first four M
    // terms and its B (npt_wide_fold), in registers, folded while the warp
    // waits on its down-sweep's shuffles rather than in the row's M.
    constexpr bool kFold = U == 1 && !Op::kTrace;
    float m3 = NEG, b_next = NEG;
    if constexpr (kFold) npt_wide_fold(NEG, NEG, NEG, NEG, p, m3, b_next);
    if (C > 1) {
        if (th < 36) HALO[th] = 0;       // no row is 0
        npt_cluster_sync();              // every CTA's slots are clear
    }
    // the previous row's M, B and K of kmer kb - 1
    float Mq = NEG, Bq = NEG, Kq = NEG;
    float lp_end = NEG;
    // lp_kk * 32 J: the tree warp's level of the warps' last elements
    float a_warps = p.lp_kk;
    for (int h = 1; h < 32 * J; h <<= 1) a_warps = npt_add(a_warps, a_warps);

    for (int t = 1; t <= nev; ++t) {
        const int par = t & 1;
        float a = p.lp_kk;
        // this row's M and B of the thread's last kmer (Mn, Bn) and of
        // kmer kb - 1 (Mp, Bp), and its last K chain element
        float v = NEG, Mp = NEG, Bp = NEG, Mn = NEG, Bn = NEG;
        if (!tree) {
            const float x = __ldg(levb + t - 1);
            // soft-clip entry into the first kmer (r9.inl:200-227)
            const float soft = (kb == 0 && (p.pre_clip || t == 1))
                ? npt_flank((float)(t - 1), p.flank0, p.clip_base,
                            p.clip_step)
                : NEG;
            float Mc = Mq, Bc = Bq, Kc = Kq;  // kmer k - 1's previous row
            for (int j0 = 0; j0 < J; j0 += U) {
                float M[U], Bv[U], Kv[U], mu[U], sg[U], cc[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int i = R.at(j0 + u);
                    M[u] = R.M[i];
                    Bv[u] = R.B[i];
                    Kv[u] = R.K[i];
                    gauss(kb + j0 + u, mu[u], sg[u], cc[u]);
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int i = R.at(j0 + u);
                    const float Kp = u > 0 ? Kv[u - 1] : Kc;
                    const float x5 = j0 + u == 0 ? soft : NEG;
                    float m_in;
                    if constexpr (!kFold) {
                        const float Mpr = u > 0 ? M[u - 1] : Mc;
                        const float Bpr = u > 0 ? Bv[u - 1] : Bc;
                        const float x0 = npt_add(p.lp_mm_self, M[u]);
                        const float x1 = npt_add(p.lp_mm_next, Mpr);
                        const float x2 = npt_add(p.lp_b3, Bv[u]);
                        const float x3 = npt_add(p.lp_b3, Bpr);
                        const float x4 = npt_add(p.lp_km, Kp);
                        const float b0 = npt_add(p.lp_mb, M[u]);
                        const float b2 = npt_add(p.lp_bb, Bv[u]);
                        if constexpr (Op::kTrace) {
                            m_in = npt_max(npt_max(npt_max(x0, x1),
                                                   npt_max(x2, x3)),
                                           npt_max(x4, x5));
                            // the LAST equal index wins (r9.inl:140-146)
                            uint32_t trM = NPT_FROM_SAME_M;
                            if (x1 == m_in) trM = NPT_FROM_PREV_M;
                            if (x2 == m_in) trM = NPT_FROM_SAME_B;
                            if (x3 == m_in) trM = NPT_FROM_PREV_B;
                            if (x4 == m_in) trM = NPT_FROM_PREV_K;
                            if (x5 == m_in) trM = NPT_FROM_SOFT;
                            Bn = npt_max(b0, b2);
                            R.TR[i] = (uint8_t)(trM |
                                                ((b2 == Bn ? 1u : 0u) << 3));
                        } else {
                            m_in = Op::op(x0, x1);
                            m_in = Op::op(m_in, x2);
                            m_in = Op::op(m_in, x3);
                            m_in = Op::op(m_in, x4);
                            m_in = j0 + u == 0 ? Op::op(m_in, x5)
                                               : npt_add(m_in, 0.0f);
                            Bn = Op::op(b0, b2);
                        }
                        R.B[i] = Bn;
                    } else {
                        // the first four terms folded last row; J = 1
                        m_in = Op::op(m3, npt_add(p.lp_km, Kp));
                        m_in = Op::op(m_in, x5);
                        Bn = b_next;
                        R.B[i] = Bn;
                    }
                    Mn = npt_add(m_in,
                                 npt_log_normal(x, mu[u], sg[u], cc[u]));
                    R.M[i] = Mn;
                }
                Mc = M[U - 1];
                Bc = Bv[U - 1];
                Kc = Kv[U - 1];
            }
            // this row's M and B of kmer kb - 1: the lane below's last,
            // the warp below's (slot w), the CTA below's (slot 0, its halo)
            Mp = __shfl_up_sync(NPT_FULL_MASK, Mn, 1);
            Bp = __shfl_up_sync(NPT_FULL_MASK, Bn, 1);
            if (lane == 31) {
                QM[par * 17 + w + 1] = Mn;
                QB[par * 17 + w + 1] = Bn;
                if (th == nk - 1 && cr + 1 < C) {
                    const uint32_t h = npt_cluster_addr(
                        npt_smem_addr(HALO + 2 * par), cr + 1);
                    npt_slot_put(h, t, Mn);
                    npt_slot_put(h + 8, t, Bn);
                }
            }
        }
        __syncthreads();                 // the warps' last M and B written
        if (!tree) {
            if (lane == 0) {
                if (w > 0) {
                    Mp = QM[par * 17 + w];
                    Bp = QB[par * 17 + w];
                } else if (cr > 0) {
                    Mp = npt_slot_take(HALO + 2 * par, t);
                    Bp = npt_slot_take(HALO + 2 * par + 1, t);
                } else {
                    Mp = Bp = NEG;
                }
            }
            // the K chain's inputs c[k] = op(lp_mk + M[k-1], lp_b3 +
            // B[k-1]), written over the previous row's K (no longer read)
            float Mc = Mp, Bc = Bp;
            for (int j0 = 0; j0 < J; j0 += U) {
                float M[U], Bv[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    M[u] = R.M[R.at(j0 + u)];
                    Bv[u] = R.B[R.at(j0 + u)];
                }
#pragma unroll
                for (int u = 0; u < U; ++u)
                    R.K[R.at(j0 + u)] = Op::op(
                        npt_add(p.lp_mk, u > 0 ? M[u - 1] : Mc),
                        npt_add(p.lp_b3, u > 0 ? Bv[u - 1] : Bc));
                Mc = M[U - 1];
                Bc = Bv[U - 1];
            }
            // up-sweep inside the thread (levels 0 ... log2 J - 1)
            for (int h = 1; h < J; h <<= 1) {
                npt_wide_level<Op>(R, 2 * h - 1, 2 * h, h, J / (2 * h), a,
                                   false, NEG, false);
                a = npt_add(a, a);
            }
            // up-sweep across the warp's lanes on the threads' last
            // elements
            v = R.K[R.at(J - 1)];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const float u = __shfl_up_sync(NPT_FULL_MASK, v, d);
                v = npt_wide_combine<Op>(((lane + 1) & (2 * d - 1)) == 0, u,
                                         a, v);
                a = npt_add(a, a);
            }
            if (lane == 31) WT[w] = v;
        }
        __syncthreads();                 // the warps' totals written

        if (tree) {
            // up-sweep across the warps' totals (lanes < NW), then the
            // CTAs' (lanes < C), then both down-sweeps; lanes past them
            // carry values nobody reads
            // (every loop unrolled over the largest NW and C, each level a
            // warp-uniform test of the actual ones)
            float z = lane < NW ? WT[lane] : NEG;
            float aw = a_warps;
#pragma unroll
            for (int d = 1; d < NPT_WIDE_MAX_KMER_THREADS / 32; d <<= 1) {
                if (d < NW) {
                    const float u = __shfl_up_sync(NPT_FULL_MASK, z, d);
                    z = npt_wide_combine<Op>(
                        ((lane + 1) & (2 * d - 1)) == 0, u, aw, z);
                    aw = npt_add(aw, aw);
                }
            }
            float cpre = NEG;            // final K at the CTA below's end
            if (C > 1) {
                // lane r hands the CTA's total to CTA r: C stores and
                // arrivals in flight at once
                const float total = __shfl_sync(NPT_FULL_MASK, z, NW - 1);
                float y = NEG;
                if (lane < C) {
                    npt_slot_put(npt_cluster_addr(
                        npt_smem_addr(TOT + par * 16 + cr), lane), t, total);
                    y = npt_slot_take(TOT + par * 16 + lane, t);
                }
#pragma unroll
                for (int d = 1; d < NPT_WIDE_MAX_CLUSTER; d <<= 1) {
                    if (d < C) {
                        const float u = __shfl_up_sync(NPT_FULL_MASK, y, d);
                        y = npt_wide_combine<Op>(
                            ((lane + 1) & (2 * d - 1)) == 0, u, aw, y);
                        aw = npt_add(aw, aw);
                    }
                }
                // the level below the root has only elements 0 and 1
                aw = aw * 0.5f;          // exact: undoes the doubling
#pragma unroll
                for (int d = NPT_WIDE_MAX_CLUSTER / 4; d >= 1; d >>= 1) {
                    if (d <= C / 4) {
                        aw = aw * 0.5f;
                        const float u = __shfl_up_sync(NPT_FULL_MASK, y, d);
                        y = npt_wide_combine<Op>(
                            ((lane + 1) & (2 * d - 1)) == d &&
                                lane + 1 >= 3 * d,
                            u, aw, y);
                    }
                }
                cpre = __shfl_sync(NPT_FULL_MASK, y, cr > 0 ? cr - 1 : 0);
                const float tot = __shfl_sync(NPT_FULL_MASK, y, cr);
                if (lane == NW - 1) z = tot;
            }
            // down-sweep across the warps: level l's first element in the
            // CTA takes the CTA below's end
#pragma unroll
            for (int d = NPT_WIDE_MAX_KMER_THREADS / 64; d >= 1; d >>= 1) {
                if (d <= NW / 2) {
                    aw = aw * 0.5f;
                    const float u = __shfl_up_sync(NPT_FULL_MASK, z, d);
                    z = npt_wide_combine<Op>(
                        ((lane + 1) & (2 * d - 1)) == d &&
                            (lane >= d || cr > 0),
                        lane >= d ? u : cpre, aw, z);
                }
            }
            if (lane < NW) WF[lane + 1] = z;
            if (lane == 0) WF[0] = cpre;
        }
        __syncthreads();                 // the tree warp's results written

        if (!tree) {
            // down-sweep across the warp's lanes: level l's first element
            // in the warp takes the warp below's end
            const float wpre = WF[w];
            // the next row's M terms that do not wait for the K chain, in
            // the shadow of this row's down-sweep
            if constexpr (kFold)
                npt_wide_fold(Mn, Bn, Mp, Bp, p, m3, b_next);
            if (lane == 31) v = WF[w + 1];
#pragma unroll
            for (int d = 16; d >= 1; d >>= 1) {
                a = a * 0.5f;
                const float u = __shfl_up_sync(NPT_FULL_MASK, v, d);
                v = npt_wide_combine<Op>(
                    ((lane + 1) & (2 * d - 1)) == d && (lane >= d || warp_pre),
                    lane >= d ? u : wpre, a, v);
            }
            const float below = __shfl_up_sync(NPT_FULL_MASK, v, 1);
            const float prev = lane > 0 ? below : (warp_pre ? wpre : NEG);
            R.K[R.at(J - 1)] = v;
            // down-sweep inside the thread: element h - 1 of each level
            // takes K[kb - 1]; global kmer 0 keeps its value
            for (int h = J / 2; h >= 1; h >>= 1) {
                a = a * 0.5f;
                npt_wide_level<Op>(R, h - 1, 2 * h, h, J / (2 * h), a, true,
                                   prev, kb > 0);
            }

            if constexpr (Op::kTrace) {
                // trK from this row's K; each group's U bytes in one store
                uint8_t* row = trb + (size_t)(t - 1) * KP + kb;
                float Kc = prev, Bc = Bp;
                for (int j0 = 0; j0 < J; j0 += U) {
                    float Kn[U], Bv[U];
                    uint32_t tr[U];
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        Kn[u] = R.K[R.at(j0 + u)];
                        Bv[u] = R.B[R.at(j0 + u)];
                        tr[u] = R.TR[R.at(j0 + u)];
                    }
                    uint32_t word = 0;
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const float kk_prev = npt_add(
                            u > 0 ? Kn[u - 1] : Kc, p.lp_kk);
                        const float cB = npt_add(p.lp_b3,
                                                 u > 0 ? Bv[u - 1] : Bc);
                        uint32_t trK = NPT_FROM_PREV_M;
                        if (cB == Kn[u]) trK = NPT_FROM_PREV_B;
                        if (kk_prev == Kn[u]) trK = NPT_FROM_PREV_K;
                        word |= (tr[u] | trK << 4) << (8 * u);
                    }
                    if constexpr (U == 4)
                        *reinterpret_cast<uint32_t*>(row + j0) = word;
                    else if constexpr (U == 2)
                        *reinterpret_cast<uint16_t*>(row + j0) =
                            (uint16_t)word;
                    else
                        row[j0] = (uint8_t)word;
                    Kc = Kn[U - 1];
                    Bc = Bv[U - 1];
                }
            } else if (last >= kb && last < kb + J &&
                       (p.post_clip || t == nev)) {
                // end contributions (r9.inl:385-396); lp_ms = 0
                const int i = R.at(last - kb);
                const float s3 = Op::op(Op::op(R.M[i], R.B[i]), R.K[i]);
                const float post = npt_flank(npt_sub((float)nev, (float)t),
                                             p.flank0, p.clip_base,
                                             p.clip_step);
                lp_end = Op::op(lp_end, npt_add(s3, post));
            }
            Mq = Mp;
            Bq = Bp;
            Kq = prev;
        }
    }
    // no CTA leaves while another may still write into its shared memory
    if (C > 1) npt_cluster_sync();
    return lp_end;
}

// Launch a wide-row kernel: `grid` segments, a cluster of C CTAs of nt
// threads each, smem bytes of dynamic shared memory each.  A refused
// launch (a cluster the card cannot place, too much shared memory)
// returns its error; nothing falls back to another geometry.
template <class... Params, class... Args>
int npt_wide_launch(void (*kernel)(Params...), int grid, int nt, int C,
                    size_t smem, cudaStream_t st, Args... args) {
    if (smem > NPT_SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (grid <= 0) return (int)cudaGetLastError();
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid * (unsigned)C);
    cfg.blockDim = dim3((unsigned)nt);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = C > 1 ? 1 : 0;
    if (C > 8) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
    }
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// This CTA's row buffer: in shared memory after the fixed part, or its
// slice of the global scratch (npt_wide_row_bytes a CTA, in launch order).
// kScratch is a template argument so that the shared-memory kernels
// address their rows as shared memory.
template <bool kScratch>
__device__ __forceinline__ float* npt_wide_rows(float* smem, float* scratch,
                                                int J, bool trace) {
    if constexpr (!kScratch) return smem + NPT_WIDE_FIXED_FLOATS;
    return reinterpret_cast<float*>(
        reinterpret_cast<char*>(scratch) +
        (size_t)blockIdx.x *
            npt_wide_row_bytes(J * ((int)blockDim.x - 32), trace));
}
