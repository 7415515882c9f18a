// R9 profile-HMM Viterbi fill with trace (kernel 3 of the Viterbi).
//
// Replaces: nanopolish_tpu/ops/pallas_profile_hmm.py _vit_kernel (:637).
// Spec: profile_hmm_fill_generic_r9 (nanopolish_profile_hmm_r9.inl:265-433);
// plain version: nanopolish_tpu_torch/ops/profile_hmm.py viterbi_fill_plain,
// which this kernel matches bit for bit.
//
// What bounds it on the H100: the event rows are a serial chain and each row
// is ~35 f32 operations per kmer over ~100-250 kmers, so a segment is bound
// by the per-row latency (the K-skip chain's log2(KP) dependent tree
// levels), not by bytes (one trace byte per cell) or by arithmetic.  On
// eventalign's path a launch holds only the wavefront's ~20-64 segments,
// so that latency is the kernel's whole time.
// Design (KP = the batch's kmer width rounded up to a power of two):
//  - KP 32..256: one warp per segment, NPT_ROW_WARPS segments per block,
//    R = KP / 32 kmers per lane, the row of profile_hmm_row.cuh in
//    registers: neighbours by __shfl_up_sync, the K chain's tree in place
//    across registers and lanes, the levels broadcast from one coalesced
//    load per 32 rows.  No shared memory and no barriers in the row loop.
//    Each lane stores its R trace bytes as one R-byte store, so a warp
//    writes a row's KP bytes coalesced;
//  - KP 512..1024: one block per segment with one thread per kmer, the
//    previous row's M/B/K scores in shared memory, the same tree through
//    shared memory with a barrier per level;
//  - KP 2048 and wider (a segment of more than 1,024 kmers): the wide row
//    of profile_hmm_wide.cuh, a cluster of up to 16 CTAs a segment when the
//    batch leaves SMs idle, its row buffer laid out [kmer of the thread]
//    [thread] in shared memory or, past 227 KB, in global scratch.
// Both evaluate K[k] = max(c[k], K[k-1] + lp_kk) on the pairwise tree of
// jax.lax.associative_scan (pairs (0,1),(2,3),... per level; up-sweep then
// down-sweep), so each K value is rounded exactly as in the JAX scan and
// the exact-tie trace decisions agree.  Every element of tree level l
// carries a = lp_kk * 2^l, so only the max-plus values move.  The trace
// byte is trM | trB << 3 | trK << 4.  Many segments per launch fill the
// SMs.

#include "profile_hmm_wide.cuh"

namespace {

// R trace bytes of one lane, stored as one R-byte word
template <int R>
__device__ __forceinline__ void npt_store_trace(uint8_t* dst,
                                                const uint32_t (&tr)[R]) {
    if constexpr (R == 1) {
        *dst = (uint8_t)tr[0];
    } else if constexpr (R == 2) {
        *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(tr[0] | tr[1] << 8);
    } else {
        uint32_t w[R / 4];
#pragma unroll
        for (int i = 0; i < R / 4; ++i)
            w[i] = tr[4 * i] | tr[4 * i + 1] << 8 | tr[4 * i + 2] << 16 |
                   tr[4 * i + 3] << 24;
        if constexpr (R == 4)
            *reinterpret_cast<uint32_t*>(dst) = w[0];
        else
            *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    }
}

template <int R>
__global__ void __launch_bounds__(32 * NPT_ROW_WARPS) viterbi_fill_warp_kernel(
        const float* __restrict__ lev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, const int* __restrict__ nev_a,
        const float* __restrict__ trans, const uint8_t* __restrict__ clips,
        float flank0, float clip_base, float clip_step, int B,
        uint8_t* __restrict__ trace) {
    constexpr int KP = 32 * R;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * NPT_ROW_WARPS + (threadIdx.x >> 5);
    if (b >= B) return;                  // the whole warp leaves together
    const int nev = nev_a[b];
    const NptFwdParams p = npt_fwd_params(trans + (size_t)b * 8,
                                          clips + (size_t)b * 2, flank0,
                                          clip_base, clip_step);
    const size_t kb = (size_t)b * KP + lane * R;
    NptRowLevels<32> lv(lev + (size_t)b * T, nev, lane);
    NptRowLane<R> s;
    npt_row_lane_init<R>(s, mu + kb, sig + kb, cc + kb, lv);
    uint8_t* trb = trace + (size_t)b * T * KP + lane * R;

    for (int t = 1; t <= nev; ++t) {
        uint32_t tr[R];
        npt_row<R, NptMaxPlus>(t, lane, p, s, lv, tr);
        npt_store_trace<R>(trb + (size_t)(t - 1) * KP, tr);
    }
}

__global__ void viterbi_fill_block_kernel(
        const float* __restrict__ lev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, int KP,
        const int* __restrict__ nev_a, const int* __restrict__ nk_a,
        const float* __restrict__ trans, const uint8_t* __restrict__ clips,
        float flank0, float clip_base, float clip_step, int B,
        uint8_t* __restrict__ trace) {
    extern __shared__ float smem[];
    float* M_s = smem;              // previous row, then this row
    float* B_s = M_s + KP;
    float* K_s = B_s + KP;
    float* V = K_s + KP;            // up-sweep levels: KP, KP/2, ..., 1
    float* R = V + 2 * KP;          // down-sweep levels, same layout

    const int b = blockIdx.x;
    const int k = threadIdx.x;
    if (b >= B) return;
    const float NEG = npt_neg_inf();
    const int nev = nev_a[b];
    const float* tr = trans + (size_t)b * 8;
    const float lp_mk = tr[0], lp_mb = tr[1], lp_mm_self = tr[2],
                lp_mm_next = tr[3], lp_bb = tr[4], lp_b3 = tr[5],
                lp_kk = tr[6], lp_km = tr[7];
    const bool pre_clip = clips[(size_t)b * 2] != 0;
    const float mu_k = mu[(size_t)b * KP + k];
    const float sg_k = sig[(size_t)b * KP + k];
    const float cc_k = cc[(size_t)b * KP + k];
    const float* levb = lev + (size_t)b * T;
    uint8_t* trb = trace + (size_t)b * T * KP;

    M_s[k] = NEG;
    B_s[k] = NEG;
    K_s[k] = NEG;
    __syncthreads();

    for (int t = 1; t <= nev; ++t) {
        const float em = npt_log_normal(__ldg(levb + t - 1), mu_k, sg_k, cc_k);
        const float M = M_s[k], Bv = B_s[k];
        const float Mp = k > 0 ? M_s[k - 1] : NEG;
        const float Bp = k > 0 ? B_s[k - 1] : NEG;
        const float Kp = k > 0 ? K_s[k - 1] : NEG;

        // soft-clip entry into the first kmer (r9.inl:200-227)
        float s_soft = NEG;
        if (k == 0 && (pre_clip || t == 1)) {
            const float i_f = (float)(t - 1);
            s_soft = (t == 1) ? flank0
                              : __fmaf_rn(npt_sub(i_f, 1.0f), clip_step, clip_base);
        }
        const float x0 = npt_add(lp_mm_self, M);
        const float x1 = npt_add(lp_mm_next, Mp);
        const float x2 = npt_add(lp_b3, Bv);
        const float x3 = npt_add(lp_b3, Bp);
        const float x4 = npt_add(lp_km, Kp);
        const float x5 = s_soft;
        const float m_in = npt_max(npt_max(npt_max(x0, x1), npt_max(x2, x3)),
                                   npt_max(x4, x5));
        // the LAST equal index wins (r9.inl:140-146)
        uint32_t trM = NPT_FROM_SAME_M;
        if (x1 == m_in) trM = NPT_FROM_PREV_M;
        if (x2 == m_in) trM = NPT_FROM_SAME_B;
        if (x3 == m_in) trM = NPT_FROM_PREV_B;
        if (x4 == m_in) trM = NPT_FROM_PREV_K;
        if (x5 == m_in) trM = NPT_FROM_SOFT;
        const float M_new = npt_add(m_in, em);
        const float b0 = npt_add(lp_mb, M);
        const float b2 = npt_add(lp_bb, Bv);
        const float B_new = npt_max(b0, b2);
        const uint32_t trB = (b2 == B_new) ? 1u : 0u;

        __syncthreads();                 // every read of the previous row done
        M_s[k] = M_new;
        B_s[k] = B_new;
        __syncthreads();

        const float cB = npt_add(lp_b3, k > 0 ? B_s[k - 1] : NEG);
        const float cM = npt_add(lp_mk, k > 0 ? M_s[k - 1] : NEG);
        V[k] = npt_max(cM, cB);
        __syncthreads();

        // K chain: associative-scan tree, up-sweep
        float a = lp_kk;
        int base = 0, n = KP;
        while (n > 1) {
            const int half = n >> 1;
            if (k < half)
                V[base + n + k] = npt_max(npt_add(V[base + 2 * k], a),
                                          V[base + 2 * k + 1]);
            __syncthreads();
            base += n;
            n = half;
            a = npt_add(a, a);
        }
        // top level (one element): result = input
        if (k == 0) R[base] = V[base];
        __syncthreads();
        // down-sweep: level l (size n, offset base) from level l+1
        while (n < KP) {
            const int n_lo = n << 1;
            const int base_lo = base - n_lo;
            a = a * 0.5f;                // exact: undoes the doubling
            if (k < n_lo) {
                float v;
                if (k & 1) v = R[base + (k >> 1)];
                else if (k == 0) v = V[base_lo];
                else v = npt_max(npt_add(R[base + (k >> 1) - 1], a), V[base_lo + k]);
                R[base_lo + k] = v;
            }
            __syncthreads();
            base = base_lo;
            n = n_lo;
        }
        const float K_new = R[k];
        const float kk_prev = npt_add(k > 0 ? R[k - 1] : NEG, lp_kk);
        uint32_t trK = NPT_FROM_PREV_M;
        if (cB == K_new) trK = NPT_FROM_PREV_B;
        if (kk_prev == K_new) trK = NPT_FROM_PREV_K;

        trb[(size_t)(t - 1) * KP + k] = (uint8_t)(trM | (trB << 3) | (trK << 4));
        K_s[k] = K_new;
        __syncthreads();
    }
}

template <bool kScratch, int U>
__global__ void __launch_bounds__(NPT_WIDE_MAX_THREADS)
viterbi_fill_wide_kernel(
        const float* __restrict__ lev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, int J, int C,
        const int* __restrict__ nev_a, const float* __restrict__ trans,
        const uint8_t* __restrict__ clips, float flank0, float clip_base,
        float clip_step, uint8_t* __restrict__ trace,
        float* __restrict__ scratch) {
    extern __shared__ float smem[];
    const int b = blockIdx.x / C;
    const int KP = J * ((int)blockDim.x - 32) * C;
    const NptFwdParams p = npt_fwd_params(trans + (size_t)b * 8,
                                          clips + (size_t)b * 2, flank0,
                                          clip_base, clip_step);
    const size_t kb = (size_t)b * KP;
    const NptFlatGauss g{mu + kb, sig + kb, cc + kb};
    npt_wide_fill<U, NptMaxPlus>(lev + (size_t)b * T, nev_a[b], g, J, C, 0, p,
                              smem, npt_wide_rows<kScratch>(smem, scratch, J,
                                                            true),
                              trace + (size_t)b * T * KP);
}

}  // namespace

// kpl: kmers per lane of the warp kernel (KP = 32 kpl, kpl 1, 2, 4 or 8),
// 0 for the block kernel, or past 1,024 kmers the wide row's kmers per
// thread, nt threads a CTA (nt - 32 kmer threads and the tree warp) and a
// cluster of C CTAs a segment (KP = kpl (nt - 32) C;
// ops/profile_hmm_viterbi.py row_layout, wide_layout).  scratch:
// the wide row's row buffers (npt_wide_row_bytes a CTA), or NULL to keep
// them in shared memory.
extern "C" int npt_launch_viterbi_fill(
        const float* lev, int T, const float* mu, const float* sig,
        const float* cc, int KP, int kpl, int nt, int C, const int* nev,
        const int* nk, const float* trans, const uint8_t* clips,
        float flank0, float clip_base, float clip_step, int B,
        uint8_t* trace, float* scratch, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (KP > 1024) {
        if (!npt_wide_geometry(KP, kpl, nt, C))
            return (int)cudaErrorInvalidValue;
        const size_t smem =
            npt_wide_smem(kpl * (nt - 32), true, scratch == nullptr);
        // U kmers of a thread at once in each loop of the row
        const auto kernel =
            kpl >= 4 ? (scratch ? viterbi_fill_wide_kernel<true, 4>
                                : viterbi_fill_wide_kernel<false, 4>)
            : kpl == 2 ? (scratch ? viterbi_fill_wide_kernel<true, 2>
                                  : viterbi_fill_wide_kernel<false, 2>)
                       : (scratch ? viterbi_fill_wide_kernel<true, 1>
                                  : viterbi_fill_wide_kernel<false, 1>);
        return npt_wide_launch(kernel, B, nt, C, smem, st, lev, T, mu, sig,
                               cc, kpl, C, nev, trans, clips, flank0,
                               clip_base, clip_step, trace, scratch);
    }
    if (kpl == 0) {
        if (KP > 1024) return (int)cudaErrorInvalidValue;
        const size_t smem = (size_t)7 * KP * sizeof(float);
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                viterbi_fill_block_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        if (B > 0)
            viterbi_fill_block_kernel<<<B, KP, smem, st>>>(
                lev, T, mu, sig, cc, KP, nev, nk, trans, clips, flank0,
                clip_base, clip_step, B, trace);
        return (int)cudaGetLastError();
    }
    const auto warp_kernel = kpl == 1 ? viterbi_fill_warp_kernel<1>
                           : kpl == 2 ? viterbi_fill_warp_kernel<2>
                           : kpl == 4 ? viterbi_fill_warp_kernel<4>
                           : kpl == 8 ? viterbi_fill_warp_kernel<8>
                                      : nullptr;
    if (warp_kernel == nullptr || KP != 32 * kpl)
        return (int)cudaErrorInvalidValue;
    if (B > 0)
        warp_kernel<<<(B + NPT_ROW_WARPS - 1) / NPT_ROW_WARPS,
                      32 * NPT_ROW_WARPS, 0, st>>>(
            lev, T, mu, sig, cc, nev, trans, clips, flank0, clip_base,
            clip_step, B, trace);
    return (int)cudaGetLastError();
}
