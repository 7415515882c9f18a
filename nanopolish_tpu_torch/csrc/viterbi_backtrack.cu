// R9 profile-HMM Viterbi traceback (kernel 4 of the Viterbi).
//
// Replaces: nanopolish_tpu/ops/pallas_profile_hmm.py _vit_backtrack_kernel
// (:758) together with the host expansion _expand_backtrack (:899).
// Spec: profile_hmm_align_r9 (nanopolish_profile_hmm_r9.cpp:73-204);
// plain version: nanopolish_tpu_torch/ops/profile_hmm.py
// viterbi_backtrack_plain, which this kernel matches exactly.
//
// What bounds it on the H100: each step's trace byte is chosen by the step
// before, so a segment's walk is a chain of dependent loads — latency, not
// bytes (one byte per step) or operations.  The trace was just written by
// the fill and sits in L2, so one thread per segment walking it directly is
// enough; many segments per launch run their chains side by side.  Each
// step is written as one packed int64 (event << 32 | kmer << 2 | state:
// 30 bits of kmer, so any width that fits in memory), which lets the host
// fetch a whole batch of paths in one copy.

#include "npt_common.cuh"

namespace {

constexpr int ST_K = 0, ST_B = 1, ST_M = 2;
constexpr int FROM_SAME_M = 0, FROM_PREV_M = 1, FROM_SAME_B = 2,
              FROM_PREV_B = 3, FROM_PREV_K = 4, FROM_SOFT = 5;

__global__ void viterbi_backtrack_kernel(
        const uint8_t* __restrict__ trace, int T, int KP,
        const int* __restrict__ nev_a, const int* __restrict__ nk_a, int B,
        long long* __restrict__ path) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int L = T + KP;
    const uint8_t* trb = trace + (size_t)b * T * KP;
    long long* out = path + (size_t)b * (1 + L);
    int row = nev_a[b], ki = nk_a[b] - 1, st = ST_M, len = 0;
    while (row > 0 && len < L) {
        out[1 + len] = ((long long)(row - 1) << 32) | ((long long)ki << 2) |
                       st;
        ++len;
        const int byte = trb[(size_t)(row - 1) * KP + ki];
        const int mv = st == ST_M ? (byte & 7)
                     : st == ST_B ? (((byte >> 3) & 1) ? FROM_SAME_B : FROM_SAME_M)
                                  : ((byte >> 4) & 7);
        if (mv == FROM_SOFT) break;
        const int nxt_st = (mv == FROM_SAME_M || mv == FROM_PREV_M) ? ST_M
                         : (mv == FROM_SAME_B || mv == FROM_PREV_B) ? ST_B : ST_K;
        if (st != ST_K) row -= 1;
        if (mv == FROM_PREV_M || mv == FROM_PREV_B || mv == FROM_PREV_K) ki -= 1;
        st = nxt_st;
        if (ki < 0) break;
    }
    out[0] = len;
}

}  // namespace

extern "C" int npt_launch_viterbi_backtrack(
        const uint8_t* trace, int T, int KP, const int* nev, const int* nk,
        int B, long long* path, void* stream) {
    if (B > 0)
        viterbi_backtrack_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
            trace, T, KP, nev, nk, B, path);
    return (int)cudaGetLastError();
}
