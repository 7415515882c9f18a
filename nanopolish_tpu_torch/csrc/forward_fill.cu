// R9 profile-HMM Forward log-likelihood per segment.
//
// Replaces: nanopolish_tpu/ops/pallas_profile_hmm.py _fwd_kernel (:97).
// Spec: profile_hmm_score_r9 (nanopolish_profile_hmm_r9.cpp:35-65) over the
// fill of nanopolish_profile_hmm_r9.inl:265-433 with logsum; plain version:
// nanopolish_tpu_torch/ops/profile_hmm.py forward_fill_plain.  It computes
// what the JAX scan path computes (ops/profile_hmm.py _profile_hmm_scan,
// viterbi=False), in the same order: log(e^x + e^y) as jnp.logaddexp
// evaluates it (max + log1pf(expf(-|x - y|)), x + y where x - y is NaN),
// the six M terms folded left to right, and the K-skip chain on
// jax.lax.associative_scan's pairwise tree.  It does not follow the Pallas
// body, whose max-shifted linear sums and -80 clamp are other arithmetic.
//
// What bounds it on the H100: operations.  Each cell costs nine logaddexps
// (an expf/log1pf pair and a few adds each) and the event rows form a serial
// chain, so a segment's time is the per-row latency: the K chain's
// 2*log2(KP) dependent tree levels and their barriers.  Bytes are a few per
// cell (one level per row, three tables per kmer, one score per segment).
// Design: one block per segment with one thread per kmer (KP = the batch's
// kmer width rounded up to a power of two, 32..1024), looping over the
// segment's event rows with the previous row's M/B/K scores in shared
// memory; the thread of the last kmer folds the end terms into the score.
// Many segments per launch fill the SMs.  Built with -fmad=false: a*b+c is
// fused only where the scan fuses it (the emission, the soft-clip flanks).

#include "npt_common.cuh"

namespace {

__device__ __forceinline__ float npt_logaddexp(float x, float y) {
    const float d = npt_sub(x, y);
    if (d != d) return npt_add(x, y);      // NaN: both -inf
    return npt_add(npt_max(x, y), log1pf(expf(-fabsf(d))));
}

__device__ __forceinline__ float npt_flank(float i_f, float flank0,
                                           float clip_base, float clip_step) {
    return i_f == 0.0f ? flank0
                       : __fmaf_rn(npt_sub(i_f, 1.0f), clip_step, clip_base);
}

__global__ void forward_fill_kernel(
        const float* __restrict__ lev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, int KP,
        const int* __restrict__ nev_a, const int* __restrict__ nk_a,
        const float* __restrict__ trans, const uint8_t* __restrict__ clips,
        float flank0, float clip_base, float clip_step, int B,
        float* __restrict__ out) {
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
    const int last = npt_clampi(nk_a[b] - 1, 0, KP - 1);
    const float* tr = trans + (size_t)b * 8;
    const float lp_mk = tr[0], lp_mb = tr[1], lp_mm_self = tr[2],
                lp_mm_next = tr[3], lp_bb = tr[4], lp_b3 = tr[5],
                lp_kk = tr[6], lp_km = tr[7];
    const bool pre_clip = clips[(size_t)b * 2] != 0;
    const bool post_clip = clips[(size_t)b * 2 + 1] != 0;
    const float mu_k = mu[(size_t)b * KP + k];
    const float sg_k = sig[(size_t)b * KP + k];
    const float cc_k = cc[(size_t)b * KP + k];
    const float* levb = lev + (size_t)b * T;

    M_s[k] = NEG;
    B_s[k] = NEG;
    K_s[k] = NEG;
    float lp_end = NEG;             // meaningful in the thread of kmer `last`
    __syncthreads();

    for (int t = 1; t <= nev; ++t) {
        const float em = npt_log_normal(__ldg(levb + t - 1), mu_k, sg_k, cc_k);
        const float M = M_s[k], Bv = B_s[k];
        const float Mp = k > 0 ? M_s[k - 1] : NEG;
        const float Bp = k > 0 ? B_s[k - 1] : NEG;
        const float Kp = k > 0 ? K_s[k - 1] : NEG;

        // soft-clip entry into the first kmer (r9.inl:200-227)
        const float s_soft = (k == 0 && (pre_clip || t == 1))
            ? npt_flank((float)(t - 1), flank0, clip_base, clip_step) : NEG;
        const float x0 = npt_add(lp_mm_self, M);
        const float x1 = npt_add(lp_mm_next, Mp);
        const float x2 = npt_add(lp_b3, Bv);
        const float x3 = npt_add(lp_b3, Bp);
        const float x4 = npt_add(lp_km, Kp);
        float m_in = npt_logaddexp(x0, x1);
        m_in = npt_logaddexp(m_in, x2);
        m_in = npt_logaddexp(m_in, x3);
        m_in = npt_logaddexp(m_in, x4);
        m_in = npt_logaddexp(m_in, s_soft);
        const float M_new = npt_add(m_in, em);
        const float B_new = npt_logaddexp(npt_add(lp_mb, M), npt_add(lp_bb, Bv));

        __syncthreads();                 // every read of the previous row done
        M_s[k] = M_new;
        B_s[k] = B_new;
        __syncthreads();

        const float cM = npt_add(lp_mk, k > 0 ? M_s[k - 1] : NEG);
        const float cB = npt_add(lp_b3, k > 0 ? B_s[k - 1] : NEG);
        V[k] = npt_logaddexp(cM, cB);
        __syncthreads();

        // K chain: associative-scan tree, up-sweep
        float a = lp_kk;
        int base = 0, n = KP;
        while (n > 1) {
            const int half = n >> 1;
            if (k < half)
                V[base + n + k] = npt_logaddexp(npt_add(V[base + 2 * k], a),
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
                else v = npt_logaddexp(npt_add(R[base + (k >> 1) - 1], a),
                                       V[base_lo + k]);
                R[base_lo + k] = v;
            }
            __syncthreads();
            base = base_lo;
            n = n_lo;
        }
        const float K_new = R[k];

        // end contributions (r9.inl:385-396); lp_ms = 0
        if (k == last && (post_clip || t == nev)) {
            const float s3 = npt_logaddexp(npt_logaddexp(M_new, B_new), K_new);
            const float post = npt_flank(npt_sub((float)nev, (float)t), flank0,
                                         clip_base, clip_step);
            lp_end = npt_logaddexp(lp_end, npt_add(s3, post));
        }
        K_s[k] = K_new;
        __syncthreads();
    }
    if (k == last) out[b] = lp_end;
}

}  // namespace

extern "C" int npt_launch_forward_fill(
        const float* lev, int T, const float* mu, const float* sig,
        const float* cc, int KP, const int* nev, const int* nk,
        const float* trans, const uint8_t* clips, float flank0,
        float clip_base, float clip_step, int B, float* out, void* stream) {
    const size_t smem = (size_t)7 * KP * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            forward_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (B > 0)
        forward_fill_kernel<<<B, KP, smem, (cudaStream_t)stream>>>(
            lev, T, mu, sig, cc, KP, nev, nk, trans, clips, flank0,
            clip_base, clip_step, B, out);
    return (int)cudaGetLastError();
}
