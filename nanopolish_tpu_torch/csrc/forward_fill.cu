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
// The row loop is npt_forward_block (forward_common.cuh), which
// csrc/forward_indexed.cu runs too.

#include "forward_common.cuh"

namespace {

__global__ void forward_fill_kernel(
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
