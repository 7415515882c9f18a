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
// chain, so a segment's time is the per-row latency of its dependent
// logaddexps and K-chain tree levels, and a full launch's time the
// instruction issue of all its cells.  Bytes are a few per cell (one level
// per row, three tables per kmer, one score per segment).
// Design (KP = the batch's kmer width rounded up to a power of two):
//  - KP 32..256 (every calling and scorereads window): one warp per
//    segment, NPT_ROW_WARPS segments per block, R = KP / 32 kmers per lane,
//    the row of profile_hmm_row.cuh in registers.  No shared memory and no
//    barriers in the row loop; the lane's R kmers give R independent
//    logaddexp chains to interleave; the levels come 32 rows per coalesced
//    load.  The lane holding the last kmer folds the end terms into the
//    score;
//  - KP 512..1024: one block per segment with one thread per kmer, the row
//    loop npt_forward_block (forward_common.cuh), which
//    csrc/forward_indexed.cu's block mode runs too;
//  - KP 2048 and wider (a whole read in the train step, a scorereads chunk
//    across deletions): the wide row of profile_hmm_wide.cuh, a cluster of
//    up to 16 CTAs a segment when the batch leaves SMs idle.
// Built with -fmad=false: a*b+c is fused only where the scan fuses it (the
// emission, the soft-clip flanks).  Every mode gives the same bits.

#include "profile_hmm_wide.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(32 * NPT_ROW_WARPS) forward_fill_warp_kernel(
        const float* __restrict__ lev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, const int* __restrict__ nev_a,
        const int* __restrict__ nk_a, const float* __restrict__ trans,
        const uint8_t* __restrict__ clips, float flank0, float clip_base,
        float clip_step, int B, float* __restrict__ out) {
    constexpr int KP = 32 * R;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * NPT_ROW_WARPS + (threadIdx.x >> 5);
    if (b >= B) return;                  // the whole warp leaves together
    const int nev = nev_a[b];
    const int last = npt_clampi(nk_a[b] - 1, 0, KP - 1);
    const int last_lane = last / R, last_r = last % R;
    const NptFwdParams p = npt_fwd_params(trans + (size_t)b * 8,
                                          clips + (size_t)b * 2, flank0,
                                          clip_base, clip_step);
    const size_t kb = (size_t)b * KP + lane * R;
    NptRowLevels<32> lv(lev + (size_t)b * T, nev, lane);
    NptRowLane<R> s;
    npt_row_lane_init<R>(s, mu + kb, sig + kb, cc + kb, lv);
    float lp_end = npt_neg_inf();

    for (int t = 1; t <= nev; ++t) {
        uint32_t unused[R];
        npt_row<R, NptLogSum>(t, lane, p, s, lv, unused);
        // end contributions (r9.inl:385-396); lp_ms = 0
        if (lane == last_lane && (p.post_clip || t == nev)) {
            float Ml = s.M[0], Bl = s.B[0], Kl = s.K[0];
#pragma unroll
            for (int r = 1; r < R; ++r)
                if (r == last_r) {
                    Ml = s.M[r];
                    Bl = s.B[r];
                    Kl = s.K[r];
                }
            const float s3 = npt_logaddexp(npt_logaddexp(Ml, Bl), Kl);
            const float post = npt_flank(npt_sub((float)nev, (float)t),
                                         p.flank0, p.clip_base, p.clip_step);
            lp_end = npt_logaddexp(lp_end, npt_add(s3, post));
        }
    }
    if (lane == last_lane) out[b] = lp_end;
}

__global__ void forward_fill_block_kernel(
        const float* __restrict__ lev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, int KP,
        const int* __restrict__ nev_a, const int* __restrict__ nk_a,
        const float* __restrict__ trans, const uint8_t* __restrict__ clips,
        float flank0, float clip_base, float clip_step, int B,
        float* __restrict__ out) {
    extern __shared__ float smem[];
    const int b = blockIdx.x;
    const int k = threadIdx.x;
    if (b >= B) return;
    const int last = npt_clampi(nk_a[b] - 1, 0, KP - 1);
    const NptFwdParams p = npt_fwd_params(trans + (size_t)b * 8,
                                          clips + (size_t)b * 2, flank0,
                                          clip_base, clip_step);
    const size_t kb = (size_t)b * KP + k;
    const float lp_end = npt_forward_block(lev + (size_t)b * T, nev_a[b],
                                           mu[kb], sig[kb], cc[kb], last, p,
                                           KP, smem);
    if (k == last) out[b] = lp_end;
}

template <bool kScratch, int U>
__global__ void __launch_bounds__(NPT_WIDE_MAX_THREADS)
forward_fill_wide_kernel(
        const float* __restrict__ lev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, int J, int C,
        const int* __restrict__ nev_a, const int* __restrict__ nk_a,
        const float* __restrict__ trans, const uint8_t* __restrict__ clips,
        float flank0, float clip_base, float clip_step,
        float* __restrict__ out, float* __restrict__ scratch) {
    extern __shared__ float smem[];
    const int b = blockIdx.x / C;
    const int KP = J * ((int)blockDim.x - 32) * C;
    const int last = npt_clampi(nk_a[b] - 1, 0, KP - 1);
    const NptFwdParams p = npt_fwd_params(trans + (size_t)b * 8,
                                          clips + (size_t)b * 2, flank0,
                                          clip_base, clip_step);
    const size_t kb = (size_t)b * KP;
    const NptFlatGauss g{mu + kb, sig + kb, cc + kb};
    const float lp_end = npt_wide_fill<U, NptLogSum>(
        lev + (size_t)b * T, nev_a[b], g, J, C, last, p, smem,
        npt_wide_rows<kScratch>(smem, scratch, J, false), nullptr);
    if (npt_wide_owns(last, J, C)) out[b] = lp_end;
}

// out[i] = npt_log1p_unit of the float whose bits are first + i
__global__ void log1p_unit_table_kernel(uint32_t first, int n,
                                        float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = npt_log1p_unit(__uint_as_float(first + (uint32_t)i));
}

}  // namespace

// npt_log1p_unit over n consecutive float bit patterns from first: lets
// chip_smoke.py hold it to torch.log1p on every float in [0, 1], the
// logaddexp's whole range, on the card that runs it.
extern "C" int npt_log1p_unit_table(unsigned first, int n, float* out,
                                    void* stream) {
    if (n > 0)
        log1p_unit_table_kernel<<<(n + 255) / 256, 256, 0,
                                  (cudaStream_t)stream>>>(first, n, out);
    return (int)cudaGetLastError();
}

// kpl: kmers per lane of the warp kernel (KP = 32 kpl, kpl 1, 2, 4 or 8),
// 0 for the block kernel, or past 1,024 kmers the wide row's kmers per
// thread, nt threads a CTA (nt - 32 kmer threads and the tree warp) and a
// cluster of C CTAs a segment (KP = kpl (nt - 32) C;
// ops/profile_hmm_viterbi.py row_layout, wide_layout).  scratch:
// the wide row's row buffers (npt_wide_row_bytes a CTA), or NULL to keep
// them in shared memory.
extern "C" int npt_launch_forward_fill(
        const float* lev, int T, const float* mu, const float* sig,
        const float* cc, int KP, int kpl, int nt, int C, const int* nev,
        const int* nk, const float* trans, const uint8_t* clips,
        float flank0, float clip_base, float clip_step, int B, float* out,
        float* scratch, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (KP > 1024) {
        if (!npt_wide_geometry(KP, kpl, nt, C))
            return (int)cudaErrorInvalidValue;
        const size_t smem =
            npt_wide_smem(kpl * (nt - 32), false, scratch == nullptr);
        // U kmers of a thread at once in each loop of the row
        const auto kernel =
            kpl >= 4 ? (scratch ? forward_fill_wide_kernel<true, 4>
                                : forward_fill_wide_kernel<false, 4>)
            : kpl == 2 ? (scratch ? forward_fill_wide_kernel<true, 2>
                                  : forward_fill_wide_kernel<false, 2>)
                       : (scratch ? forward_fill_wide_kernel<true, 1>
                                  : forward_fill_wide_kernel<false, 1>);
        return npt_wide_launch(kernel, B, nt, C, smem, st, lev, T, mu, sig,
                               cc, kpl, C, nev, nk, trans, clips, flank0,
                               clip_base, clip_step, out, scratch);
    }
    if (kpl == 0) {
        if (KP > 1024) return (int)cudaErrorInvalidValue;
        const size_t smem = (size_t)7 * KP * sizeof(float);
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                forward_fill_block_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        if (B > 0)
            forward_fill_block_kernel<<<B, KP, smem, st>>>(
                lev, T, mu, sig, cc, KP, nev, nk, trans, clips, flank0,
                clip_base, clip_step, B, out);
        return (int)cudaGetLastError();
    }
    const auto warp_kernel = kpl == 1 ? forward_fill_warp_kernel<1>
                           : kpl == 2 ? forward_fill_warp_kernel<2>
                           : kpl == 4 ? forward_fill_warp_kernel<4>
                           : kpl == 8 ? forward_fill_warp_kernel<8>
                                      : nullptr;
    if (warp_kernel == nullptr || KP != 32 * kpl)
        return (int)cudaErrorInvalidValue;
    if (B > 0)
        warp_kernel<<<(B + NPT_ROW_WARPS - 1) / NPT_ROW_WARPS,
                      32 * NPT_ROW_WARPS, 0, st>>>(
            lev, T, mu, sig, cc, nev, nk, trans, clips, flank0, clip_base,
            clip_step, B, out);
    return (int)cudaGetLastError();
}
