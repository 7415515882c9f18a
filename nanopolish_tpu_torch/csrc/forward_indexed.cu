// R9 profile-HMM Forward log-likelihood per segment, from indexed inputs.
//
// Replaces: nanopolish_tpu/ops/pallas_profile_hmm.py _fwd_packed_kernel
// (:987), the Forward drain of variants (forward_packed, :1304).  Plain
// version: nanopolish_tpu_torch/ops/profile_hmm.py forward_indexed_plain.
//
// What it computes: one Forward score per segment, exactly as
// csrc/forward_fill.cu scores the segment's gathered flat inputs (the
// arithmetic of forward_common.cuh, which follows the JAX scan path and
// not the Pallas body).  A segment is four ids into inputs shared by many
// segments: an event row of levels_u [E, Tc], a read's table row of
// tabs [3, R, S] (mu, sigma, c), a kmer-rank row of rank_mat [U, Kc] and a
// transition row of trans_u [R2, 8].  The kernel gathers its levels and
// gaussians itself, so a flush uploads each unique piece once and the
// tables stay resident for all of its launches.
//
// What bounds it on the H100: operations, and the serial event rows.
// Each (event, kmer) cell costs nine logaddexps (an expf/log1pf pair and a
// few adds each); bytes are a few per segment, since the levels, ranks
// and tables are shared.  A segment's time is its rows' latency, so the
// design cuts the per-row latency:
//  - segments of up to 32 kmers (every variants screening window, ~16
//    kmers): one warp per segment, eight segments per block, the row in
//    registers.  Neighbouring kmers come from __shfl_up_sync, and the K
//    chain runs the pairwise tree of forward_fill.cu in place across the
//    lanes: the up-sweep leaves level l's element j in lane (j+1)*2^l - 1,
//    and the down-sweep fills the even elements of each level from the
//    lane 2^l below.  No barriers and no shared memory;
//  - wider segments (calling windows, up to 256 kmers): one block of KP
//    threads per segment, the row loop of forward_fill.cu
//    (npt_forward_block).
// The lane-packed rows of the TPU kernel (its pos/rev lane maps and
// segmented roll-scans) are not carried over: a warp holds one window.
// Built with -fmad=false, so both modes equal forward_fill bit for bit.

#include "forward_common.cuh"

namespace {

constexpr int WARPS = 8;            // segments per block in warp mode

// Segment s's ids, lengths and kmer k's gaussian (padding past n_kmers:
// mu 0, sigma 1, c of sigma 1).
struct NptIndexedSeg {
    const float* levb;
    int nev, nk;
    float mu, sg, cc;
};

__device__ __forceinline__ NptIndexedSeg npt_indexed_seg(
        int s, int k, const float* __restrict__ lev_u, int Tc,
        const int* __restrict__ nev_u, const float* __restrict__ tabs,
        int R, int S, const int* __restrict__ rank_mat, int Kc,
        const int* __restrict__ nkm_u, const int* __restrict__ ids,
        float pad_c) {
    const int* id = ids + (size_t)s * 4;
    const int ev = id[0], tab = id[1], rid = id[2];
    NptIndexedSeg g;
    g.levb = lev_u + (size_t)ev * Tc;
    g.nev = nev_u[ev];
    g.nk = nkm_u[rid];
    g.mu = 0.0f;
    g.sg = 1.0f;
    g.cc = pad_c;
    if (k < g.nk) {
        const size_t r = (size_t)tab * S + rank_mat[(size_t)rid * Kc + k];
        const size_t plane = (size_t)R * S;
        g.mu = __ldg(tabs + r);
        g.sg = __ldg(tabs + plane + r);
        g.cc = __ldg(tabs + 2 * plane + r);
    }
    return g;
}

__global__ void forward_indexed_warp_kernel(
        const float* __restrict__ lev_u, int Tc, const int* __restrict__ nev_u,
        const float* __restrict__ tabs, int R, int S,
        const int* __restrict__ rank_mat, int Kc,
        const int* __restrict__ nkm_u, const float* __restrict__ trans_u,
        const int* __restrict__ ids, const uint8_t* __restrict__ clips,
        float flank0, float clip_base, float clip_step, float pad_c, int n,
        float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (s >= n) return;                  // the whole warp leaves together
    const NptIndexedSeg g = npt_indexed_seg(s, lane, lev_u, Tc, nev_u, tabs,
                                            R, S, rank_mat, Kc, nkm_u, ids,
                                            pad_c);
    const NptFwdParams p = npt_fwd_params(
        trans_u + (size_t)ids[(size_t)s * 4 + 3] * 8, clips + (size_t)s * 2,
        flank0, clip_base, clip_step);
    const int last = npt_clampi(g.nk - 1, 0, 31);
    const float NEG = npt_neg_inf();
    float M = NEG, Bv = NEG, Kv = NEG, lp_end = NEG;

    for (int t = 1; t <= g.nev; ++t) {
        const float em = npt_log_normal(__ldg(g.levb + t - 1), g.mu, g.sg,
                                        g.cc);
        const float Mp = npt_shfl_prev(M, 1, lane);
        const float Bp = npt_shfl_prev(Bv, 1, lane);
        const float Kp = npt_shfl_prev(Kv, 1, lane);

        // soft-clip entry into the first kmer (r9.inl:200-227)
        const float s_soft = (lane == 0 && (p.pre_clip || t == 1))
            ? npt_flank((float)(t - 1), p.flank0, p.clip_base, p.clip_step)
            : NEG;
        const float x0 = npt_add(p.lp_mm_self, M);
        const float x1 = npt_add(p.lp_mm_next, Mp);
        const float x2 = npt_add(p.lp_b3, Bv);
        const float x3 = npt_add(p.lp_b3, Bp);
        const float x4 = npt_add(p.lp_km, Kp);
        float m_in = npt_logaddexp(x0, x1);
        m_in = npt_logaddexp(m_in, x2);
        m_in = npt_logaddexp(m_in, x3);
        m_in = npt_logaddexp(m_in, x4);
        m_in = npt_logaddexp(m_in, s_soft);
        const float M_new = npt_add(m_in, em);
        const float B_new = npt_logaddexp(npt_add(p.lp_mb, M),
                                          npt_add(p.lp_bb, Bv));

        const float cM = npt_add(p.lp_mk, npt_shfl_prev(M_new, 1, lane));
        const float cB = npt_add(p.lp_b3, npt_shfl_prev(B_new, 1, lane));
        float v = npt_logaddexp(cM, cB);

        // K chain on the associative-scan tree of npt_forward_block at
        // KP = 32.  Up-sweep: level l+1's element j = (level l's 2j + a_l)
        // (+) level l's 2j+1, in lane (j+1)*2^(l+1) - 1, a_l = lp_kk * 2^l.
        float a = p.lp_kk;
        for (int d = 1; d < 32; d <<= 1) {
            const float u = __shfl_up_sync(NPT_FULL_MASK, v, d);
            if (((lane + 1) & (2 * d - 1)) == 0)
                v = npt_logaddexp(npt_add(u, a), v);
            a = npt_add(a, a);
        }
        // down-sweep: level l's even element k > 0 (lane (k+1)*2^l - 1) =
        // (level l+1's k/2 - 1, the lane 2^l below, + a_l) (+) its up-sweep
        // value; odd elements and element 0 keep theirs
        for (int d = 16; d >= 1; d >>= 1) {
            a = a * 0.5f;                // exact: undoes the doubling
            const float u = __shfl_up_sync(NPT_FULL_MASK, v, d);
            if (((lane + 1) & (2 * d - 1)) == d && lane + 1 >= 3 * d)
                v = npt_logaddexp(npt_add(u, a), v);
        }
        const float K_new = v;

        // end contributions (r9.inl:385-396); lp_ms = 0
        if (lane == last && (p.post_clip || t == g.nev)) {
            const float s3 = npt_logaddexp(npt_logaddexp(M_new, B_new), K_new);
            const float post = npt_flank(npt_sub((float)g.nev, (float)t),
                                         p.flank0, p.clip_base, p.clip_step);
            lp_end = npt_logaddexp(lp_end, npt_add(s3, post));
        }
        M = M_new;
        Bv = B_new;
        Kv = K_new;
    }
    if (lane == last) out[s] = lp_end;
}

__global__ void forward_indexed_block_kernel(
        const float* __restrict__ lev_u, int Tc, const int* __restrict__ nev_u,
        const float* __restrict__ tabs, int R, int S,
        const int* __restrict__ rank_mat, int Kc,
        const int* __restrict__ nkm_u, const float* __restrict__ trans_u,
        const int* __restrict__ ids, const uint8_t* __restrict__ clips,
        float flank0, float clip_base, float clip_step, float pad_c, int KP,
        int n, float* __restrict__ out) {
    extern __shared__ float smem[];
    const int s = blockIdx.x;
    const int k = threadIdx.x;
    if (s >= n) return;
    const NptIndexedSeg g = npt_indexed_seg(s, k, lev_u, Tc, nev_u, tabs, R,
                                            S, rank_mat, Kc, nkm_u, ids,
                                            pad_c);
    const NptFwdParams p = npt_fwd_params(
        trans_u + (size_t)ids[(size_t)s * 4 + 3] * 8, clips + (size_t)s * 2,
        flank0, clip_base, clip_step);
    const int last = npt_clampi(g.nk - 1, 0, KP - 1);
    const float lp_end = npt_forward_block(g.levb, g.nev, g.mu, g.sg, g.cc,
                                           last, p, KP, smem);
    if (k == last) out[s] = lp_end;
}

}  // namespace

extern "C" int npt_launch_forward_indexed(
        const float* lev_u, int Tc, const int* nev_u, const float* tabs,
        int R, int S, const int* rank_mat, int Kc, const int* nkm_u,
        const float* trans_u, const int* ids, const uint8_t* clips,
        float flank0, float clip_base, float clip_step, float pad_c, int KP,
        int n, float* out, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (KP == 32) {
        forward_indexed_warp_kernel<<<(n + WARPS - 1) / WARPS, 32 * WARPS, 0,
                                      st>>>(
            lev_u, Tc, nev_u, tabs, R, S, rank_mat, Kc, nkm_u, trans_u, ids,
            clips, flank0, clip_base, clip_step, pad_c, n, out);
    } else {
        const size_t smem = (size_t)7 * KP * sizeof(float);
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                forward_indexed_block_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        forward_indexed_block_kernel<<<n, KP, smem, st>>>(
            lev_u, Tc, nev_u, tabs, R, S, rank_mat, Kc, nkm_u, trans_u, ids,
            clips, flank0, clip_base, clip_step, pad_c, KP, n, out);
    }
    return (int)cudaGetLastError();
}
