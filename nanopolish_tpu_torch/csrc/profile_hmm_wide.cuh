// The wide row of the profile-HMM fills: kmer widths KP = 1024 J above
// 1,024 (J = 2, 4, 8, ... kmers per thread), for csrc/viterbi_fill.cu,
// csrc/forward_fill.cu and csrc/forward_indexed.cu.
//
// One block of 1,024 threads holds one segment; thread t holds kmers
// t J ... t J + J - 1.  The previous row's M, B and K scores (4 bytes per
// kmer each) live in a row buffer: shared memory when 12 KP bytes and the
// tree's 4 KB fit in a block's 227 KB, else the global scratch that the
// wrapper allocates ([B, 3, KP] f32), so that no width that fits in memory
// is refused.  A thread sweeps its kmers in order, carrying kmer k - 1's
// scores; its first kmer's neighbour is the thread below's last, read
// before a barrier.
//
// The K-skip chain runs on jax.lax.associative_scan's pairwise tree as
// profile_hmm_row.cuh runs it across lanes: levels 0 ... log2 J - 1 inside
// a thread (in place in the row buffer), then levels log2 J ... on the
// threads' last elements in place in a 1,024-float shared array, at
// thread distance 2^l / J with a barrier per level (the lanes' schedule of
// npt_row_kchain with 1,024 lanes), then the down-sweep mirrors it.  Every
// element of level l carries a = lp_kk * 2^l, so every K value and every
// exact-tie trace decision is rounded as the plain versions round it.
//
// Speed is not its point: a row costs ~2 log2(1024) + 3 barriers and
// J-kmer sweeps through the buffer.  It is the counterpart of the
// reference's rare wide chunk (a long deletion inside a scorereads chunk).
#pragma once

#include "profile_hmm_row.cuh"

constexpr int NPT_WIDE_THREADS = 1024;
// a block's shared memory on sm_90 (227 KB)
constexpr size_t NPT_SMEM_BLOCK_MAX = 232448;

// The wide row's shared memory: the tree, plus the row buffer unless it
// is in global scratch.
__host__ __device__ inline size_t npt_wide_smem(int KP, bool rows_in_smem) {
    return (size_t)NPT_WIDE_THREADS * sizeof(float) +
           (rows_in_smem ? (size_t)3 * KP * sizeof(float) : 0);
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

// One segment's fill on the wide row.  Every thread of the block calls it.
// levb: the segment's nev levels; gauss(k, mu, sigma, c): kmer k's
// gaussian; rows: 3 KP floats (shared or global); X: 1,024 shared floats.
// Viterbi (Op::kTrace): writes trace byte trM | trB << 3 | trK << 4 of
// each live row to trb[(t - 1) KP + k].  Forward: returns the score in the
// thread holding kmer `last`.
template <class Op, class Gauss>
__device__ float npt_wide_fill(const float* __restrict__ levb, int nev,
                               const Gauss& gauss, int J, int last,
                               const NptFwdParams& p, float* rows, float* X,
                               uint8_t* __restrict__ trb) {
    const int KP = J * NPT_WIDE_THREADS;
    float* Ms = rows;
    float* Bs = rows + KP;
    float* Ks = rows + 2 * KP;
    const int th = threadIdx.x;
    const int k0 = th * J;
    const float NEG = npt_neg_inf();
    float lp_end = NEG;

    for (int j = 0; j < J; ++j) Ms[k0 + j] = Bs[k0 + j] = Ks[k0 + j] = NEG;
    __syncthreads();

    for (int t = 1; t <= nev; ++t) {
        const float x = __ldg(levb + t - 1);
        // the previous row's scores of kmer k0 - 1 (the thread below's)
        float Mq = th > 0 ? Ms[k0 - 1] : NEG;
        float Bq = th > 0 ? Bs[k0 - 1] : NEG;
        float Kq = th > 0 ? Ks[k0 - 1] : NEG;
        __syncthreads();                 // every read of another's row done

        // soft-clip entry into the first kmer (r9.inl:200-227)
        const float soft = (th == 0 && (p.pre_clip || t == 1))
            ? npt_flank((float)(t - 1), p.flank0, p.clip_base, p.clip_step)
            : NEG;
        for (int j = 0; j < J; ++j) {
            const int k = k0 + j;
            const float M = Ms[k], Bv = Bs[k], Kv = Ks[k];
            const float x0 = npt_add(p.lp_mm_self, M);
            const float x1 = npt_add(p.lp_mm_next, Mq);
            const float x2 = npt_add(p.lp_b3, Bv);
            const float x3 = npt_add(p.lp_b3, Bq);
            const float x4 = npt_add(p.lp_km, Kq);
            const float x5 = k == 0 ? soft : NEG;
            const float b0 = npt_add(p.lp_mb, M);
            const float b2 = npt_add(p.lp_bb, Bv);
            float m_in, Bn;
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
                Bn = npt_max(b0, b2);
                trb[(size_t)(t - 1) * KP + k] =
                    (uint8_t)(trM | ((b2 == Bn ? 1u : 0u) << 3));
            } else {
                m_in = Op::op(x0, x1);
                m_in = Op::op(m_in, x2);
                m_in = Op::op(m_in, x3);
                m_in = Op::op(m_in, x4);
                // logaddexp(m, -inf) is m + 0.0f bit for bit
                m_in = k == 0 ? Op::op(m_in, x5) : npt_add(m_in, 0.0f);
                Bn = Op::op(b0, b2);
            }
            float mu, sg, cc;
            gauss(k, mu, sg, cc);
            Ms[k] = npt_add(m_in, npt_log_normal(x, mu, sg, cc));
            Bs[k] = Bn;
            Mq = M;
            Bq = Bv;
            Kq = Kv;
        }
        __syncthreads();                 // this row's M and B in place

        // the K chain's inputs c[k] = op(lp_mk + M[k-1], lp_b3 + B[k-1]),
        // written over the previous row's K (no longer read)
        const float Mq1 = th > 0 ? Ms[k0 - 1] : NEG;
        const float Bq1 = th > 0 ? Bs[k0 - 1] : NEG;
        for (int j = 0; j < J; ++j) {
            const int k = k0 + j;
            const float cM = npt_add(p.lp_mk, j > 0 ? Ms[k - 1] : Mq1);
            const float cB = npt_add(p.lp_b3, j > 0 ? Bs[k - 1] : Bq1);
            Ks[k] = Op::op(cM, cB);
        }
        // up-sweep inside the thread
        float a = p.lp_kk;
        for (int h = 1; h < J; h <<= 1) {
            for (int r = 2 * h - 1; r < J; r += 2 * h)
                Ks[k0 + r] = Op::op(npt_add(Ks[k0 + r - h], a), Ks[k0 + r]);
            a = npt_add(a, a);
        }
        // up-sweep across threads on their last elements, in place in X
        X[th] = Ks[k0 + J - 1];
        __syncthreads();
        for (int d = 1; d < NPT_WIDE_THREADS; d <<= 1) {
            if (((th + 1) & (2 * d - 1)) == 0)
                X[th] = Op::op(npt_add(X[th - d], a), X[th]);
            a = npt_add(a, a);
            __syncthreads();
        }
        // down-sweep across threads; the level below the root (d = 512)
        // has only elements 0 and 1
        a = a * 0.5f;                    // exact: undoes the doubling
        for (int d = NPT_WIDE_THREADS / 4; d >= 1; d >>= 1) {
            a = a * 0.5f;
            if (((th + 1) & (2 * d - 1)) == d && th + 1 >= 3 * d)
                X[th] = Op::op(npt_add(X[th - d], a), X[th]);
            __syncthreads();
        }
        Ks[k0 + J - 1] = X[th];
        const float prev = th > 0 ? X[th - 1] : NEG;     // K[k0 - 1]
        // down-sweep inside the thread
        for (int h = J / 2; h >= 1; h >>= 1) {
            a = a * 0.5f;
            for (int r = h - 1; r < J; r += 2 * h) {
                if (r == h - 1) {
                    if (th > 0)
                        Ks[k0 + r] = Op::op(npt_add(prev, a), Ks[k0 + r]);
                } else {
                    Ks[k0 + r] = Op::op(npt_add(Ks[k0 + r - h], a),
                                        Ks[k0 + r]);
                }
            }
        }

        if constexpr (Op::kTrace) {
            for (int j = 0; j < J; ++j) {
                const int k = k0 + j;
                const float Kn = Ks[k];
                const float kk_prev = npt_add(j > 0 ? Ks[k - 1] : prev,
                                              p.lp_kk);
                const float cB = npt_add(p.lp_b3, j > 0 ? Bs[k - 1] : Bq1);
                uint32_t trK = NPT_FROM_PREV_M;
                if (cB == Kn) trK = NPT_FROM_PREV_B;
                if (kk_prev == Kn) trK = NPT_FROM_PREV_K;
                uint8_t* cell = trb + (size_t)(t - 1) * KP + k;
                *cell = (uint8_t)(*cell | (trK << 4));
            }
        } else {
            // end contributions (r9.inl:385-396); lp_ms = 0
            if (last >= k0 && last < k0 + J && (p.post_clip || t == nev)) {
                const float s3 = Op::op(Op::op(Ms[last], Bs[last]), Ks[last]);
                const float post = npt_flank(npt_sub((float)nev, (float)t),
                                             p.flank0, p.clip_base,
                                             p.clip_step);
                lp_end = Op::op(lp_end, npt_add(s3, post));
            }
        }
        __syncthreads();                 // the row is complete
    }
    return lp_end;
}
