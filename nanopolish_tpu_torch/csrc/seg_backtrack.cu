// Segmentation backtrack with the summary fused: backpointers -> labels ->
// the five numbers polya and detect-polyi need per read.
//
// Replaces: nanopolish_tpu/ops/pallas_segmentation.py _seg_back_kernel
// (:177) together with the XLA reduction _seg_summary (:297).  Spec: the
// reference's backward loop (nanopolish_polya_estimator.cpp:446-456) as
// the JAX scan path's _backward_labels indexes it: label[n-1] = T,
// label[t] = bptr[t][label[t+1]] for 1 <= t <= n-2, label[0] = S.  Plain
// version: nanopolish_tpu_torch/ops/segmentation_hmm.py
// seg_backtrack_plain (labels, then seg_summary_plain), which this kernel
// matches exactly.
//
// What bounds it on the H100: each step's label is chosen by the step
// after it, so a read is a chain of n dependent decodes — latency, not
// bytes (one byte per sample) or operations.  The design: one thread per
// read walking backward along its row of the read-major [B, N]
// backpointers (csrc/seg_viterbi_fill.cu writes them so); the byte loads
// do not depend on the state, so each thread loads eight bytes ahead of
// its walk.  The summary (the last
// S->L, L->A, A->P, P->T transition index, -1 if none, and the CLIFF
// count) is kept in registers: walking backward, the first time a pair
// is seen is its last index.  Labels reach memory only when the caller
// passes an array for them (tests, chip_smoke); the main path fetches the
// [B, 5] summary alone.

#include "npt_common.cuh"

namespace {

constexpr int S = 0, L = 1, A = 2, P = 3, C = 4, T = 5;
constexpr int AHEAD = 8;

__device__ __forceinline__ int decode(int byte, int state) {
    switch (state) {
        case L: return (byte & 1) ? L : S;
        case A: return (byte & 2) ? A : L;
        case P: {
            const int code = (byte >> 2) & 3;
            return code == 0 ? P : (code == 1 ? A : C);
        }
        case C: return (byte & 16) ? C : P;
        case T: return (byte & 32) ? T : P;
        default: return S;
    }
}

struct Summary {
    int s_l = -1, l_a = -1, a_p = -1, p_t = -1, cliffs = 0;
    // label[t] = lab, label[t + 1] = nxt
    __device__ __forceinline__ void see(int t, int lab, int nxt) {
        if (lab == S && nxt == L && s_l < 0) s_l = t;
        if (lab == L && nxt == A && l_a < 0) l_a = t;
        if (lab == A && nxt == P && a_p < 0) a_p = t;
        if (lab == P && nxt == T && p_t < 0) p_t = t;
    }
};

__global__ void seg_backtrack_kernel(
        const uint8_t* __restrict__ bptr, int N, int B,
        const int* __restrict__ n_a, int* __restrict__ summary,
        uint8_t* __restrict__ labels) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int n = min(n_a[b], N);
    const uint8_t* col = bptr + (size_t)b * N;
    Summary sm;
    if (n >= 1) {
        int nxt = T;                                  // label[n - 1]
        if (labels) labels[(size_t)(n - 1) * B + b] = T;
        for (int t0 = n - 2; t0 >= 1; t0 -= AHEAD) {
            int buf[AHEAD];
#pragma unroll
            for (int j = 0; j < AHEAD; ++j)
                buf[j] = t0 - j >= 1 ? col[t0 - j] : 0;
#pragma unroll
            for (int j = 0; j < AHEAD; ++j) {
                const int t = t0 - j;
                if (t < 1) break;
                const int lab = decode(buf[j], nxt);
                sm.see(t, lab, nxt);
                sm.cliffs += lab == C;
                if (labels) labels[(size_t)t * B + b] = (uint8_t)lab;
                nxt = lab;
            }
        }
        if (n >= 2) {                                 // label[0] = S
            sm.see(0, S, nxt);
            if (labels) labels[b] = S;
        }
    }
    int* out = summary + (size_t)b * 5;
    out[0] = sm.s_l; out[1] = sm.l_a; out[2] = sm.a_p; out[3] = sm.p_t;
    out[4] = sm.cliffs;
}

}  // namespace

// bptr: [B, N] uint8, read-major.  labels: [N, B] uint8 pre-filled with T
// by the caller, or NULL.
extern "C" int npt_launch_seg_backtrack(
        const uint8_t* bptr, int N, int B, const int* n, int* summary,
        uint8_t* labels, void* stream) {
    if (B > 0)
        seg_backtrack_kernel<<<(B + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
            bptr, N, B, n, summary, labels);
    return (int)cudaGetLastError();
}
