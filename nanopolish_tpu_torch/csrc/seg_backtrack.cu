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
// What bounds it on the H100: walked one sample at a time, a read is a
// chain of n dependent decodes (latency, not its one byte per sample).
// The design removes the chain.  There are six states, so a backpointer
// byte is a map f_b of the states to their predecessors, and walking a
// run of samples is composing their maps, which is associative:
//   * one block of THREADS threads per read; the read's walk [1, n-2]
//     goes in tiles of THREADS x SPT samples from its end towards its
//     start, each thread a 16-byte group (one aligned uint4 load; the
//     groups follow the row's own alignment, so a read's first and last
//     groups may hold bytes outside [1, n-2], which map to the identity);
//   * a map is six 5-bit fields in one word, field s at bit 5s holding
//     5 x f(s), so applying it to a state x (kept as 5x) is one shift and
//     one mask, and composing two is six of those (the 64 byte maps are a
//     shared-memory table built from the decode rule);
//   * each thread composes its 16 maps, highest sample first (six
//     independent chains); the block scans the threads' maps (a warp scan
//     of shuffles, then each warp applies the earlier warps' totals), so
//     each thread knows the state it enters its group with, and the tile's
//     exit state enters the next tile (the only dependence between tiles:
//     WARPS applications);
//   * each thread replays its 16 bytes from registers, keeping the highest
//     t of the S->L, L->A, A->P and P->T pairs it sees (the pair across
//     its group's upper edge included: it knows its entry state) and its
//     CLIFF count; the block reduces them with max and +, which is the
//     reference's "last index" since the threads' ranges are disjoint.
// Labels are integers, so the result is exact by construction.  Labels
// reach memory only when the caller passes an array for them (tests,
// chip_smoke); the main path fetches the [B, 5] summary alone.

#include "npt_common.cuh"

namespace {

constexpr int S = 0, L = 1, A = 2, P = 3, C = 4, T = 5;
constexpr int THREADS = 256;          // one block per read
constexpr int SPT = 16;               // samples a thread per tile
constexpr int WARPS = THREADS / 32;

// the identity map: field s holds 5 s
constexpr unsigned IDENT = (0u << 0) | (5u << 5) | (10u << 10) | (15u << 15) |
                           (20u << 20) | (25u << 25);

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

// the state (times 5) that map m sends x5 to
__device__ __forceinline__ int apply(unsigned m, int x5) {
    return (int)((m >> x5) & 31u);
}

// the map "first a, then b"
__device__ __forceinline__ unsigned compose(unsigned a, unsigned b) {
    unsigned c = 0;
#pragma unroll
    for (int s = 0; s < 6; ++s)
        c |= (unsigned)apply(b, (int)((a >> (5 * s)) & 31u)) << (5 * s);
    return c;
}

__global__ void __launch_bounds__(THREADS) seg_backtrack_kernel(
        const uint8_t* __restrict__ bptr, int N, int B,
        const int* __restrict__ n_a, int* __restrict__ summary,
        uint8_t* __restrict__ labels) {
    __shared__ unsigned tab[64];
    __shared__ unsigned tot[2][WARPS];
    __shared__ int red[WARPS][5];
    const int b = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    if (tid < 64) {
        unsigned m = 0;
        for (int s = 0; s < 6; ++s) m |= (unsigned)(5 * decode(tid, s)) << (5 * s);
        tab[tid] = m;
    }
    __syncthreads();
    const int n = min(n_a[b], N);
    const uint8_t* row = bptr + (size_t)b * N;
    const int a = (int)((uintptr_t)row & 15);
    const uint8_t* base = row - a;            // sample t is base[t + a]
    int s_l = -1, l_a = -1, a_p = -1, p_t = -1, cliffs = 0;
    int x5 = 5 * T;                           // the state entering a tile
    if (n >= 3) {
        const int g_hi = (n - 2 + a) >> 4, g_lo = (1 + a) >> 4;
        int g = g_hi - tid;                   // this thread's group
        uint4 cur = make_uint4(0, 0, 0, 0);
        if (g >= g_lo) cur = *reinterpret_cast<const uint4*>(base + 16 * (size_t)g);
        for (int k = 0; g_hi - k * THREADS >= g_lo; ++k, g -= THREADS) {
            uint4 nxt = make_uint4(0, 0, 0, 0);
            if (g - THREADS >= g_lo)
                nxt = *reinterpret_cast<const uint4*>(base + 16 * (size_t)(g - THREADS));
            const unsigned w[4] = {cur.x, cur.y, cur.z, cur.w};
            const int t0 = 16 * g - a;        // the sample of byte 0
            unsigned m[SPT];
            int live = 0;                     // bit i: sample t0 + i in [1, n-2]
#pragma unroll
            for (int i = 0; i < SPT; ++i) {
                const int t = t0 + i;
                const bool in = g >= g_lo && t >= 1 && t <= n - 2;
                m[i] = in ? tab[(w[i >> 2] >> (8 * (i & 3))) & 63] : IDENT;
                live |= (int)in << i;
            }
            // compose the group's maps, highest sample first
            int f[6] = {0, 5, 10, 15, 20, 25};
#pragma unroll
            for (int i = SPT - 1; i >= 0; --i)
#pragma unroll
                for (int s = 0; s < 6; ++s) f[s] = apply(m[i], f[s]);
            unsigned inc = 0;
#pragma unroll
            for (int s = 0; s < 6; ++s) inc |= (unsigned)f[s] << (5 * s);
            // warp scan: lane 0 holds the warp's highest group
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const unsigned o = __shfl_up_sync(NPT_FULL_MASK, inc, d);
                if (lane >= d) inc = compose(o, inc);
            }
            unsigned exc = __shfl_up_sync(NPT_FULL_MASK, inc, 1);
            if (lane == 0) exc = IDENT;
            if (lane == 31) tot[k & 1][warp] = inc;
            __syncthreads();                  // tot[k & 1] is rewritten two tiles on
            int y5 = x5, e5 = x5;
#pragma unroll
            for (int v = 0; v < WARPS; ++v) {
                const unsigned tv = tot[k & 1][v];
                if (v < warp) y5 = apply(tv, y5);
                e5 = apply(tv, e5);
            }
            y5 = apply(exc, y5);              // label[t + 1] of my top sample
            // replay the group from the state it enters with
#pragma unroll
            for (int i = SPT - 1; i >= 0; --i) {
                const int t = t0 + i;
                const int lab5 = apply(m[i], y5);
                if ((live >> i) & 1) {
                    if (lab5 == 5 * S && y5 == 5 * L) s_l = max(s_l, t);
                    if (lab5 == 5 * L && y5 == 5 * A) l_a = max(l_a, t);
                    if (lab5 == 5 * A && y5 == 5 * P) a_p = max(a_p, t);
                    if (lab5 == 5 * P && y5 == 5 * T) p_t = max(p_t, t);
                    cliffs += lab5 == 5 * C;
                    if (labels) labels[(size_t)t * B + b] = (uint8_t)((lab5 * 13) >> 6);
                }
                y5 = lab5;
            }
            x5 = e5;
            cur = nxt;
        }
    }
    s_l = __reduce_max_sync(NPT_FULL_MASK, s_l);
    l_a = __reduce_max_sync(NPT_FULL_MASK, l_a);
    a_p = __reduce_max_sync(NPT_FULL_MASK, a_p);
    p_t = __reduce_max_sync(NPT_FULL_MASK, p_t);
    cliffs = __reduce_add_sync(NPT_FULL_MASK, cliffs);
    if (lane == 0) {
        red[warp][0] = s_l; red[warp][1] = l_a; red[warp][2] = a_p;
        red[warp][3] = p_t; red[warp][4] = cliffs;
    }
    __syncthreads();
    if (tid == 0) {
        for (int v = 1; v < WARPS; ++v) {
            s_l = max(s_l, red[v][0]); l_a = max(l_a, red[v][1]);
            a_p = max(a_p, red[v][2]); p_t = max(p_t, red[v][3]);
            cliffs += red[v][4];
        }
        if (n >= 1 && labels) labels[(size_t)(n - 1) * B + b] = T;
        if (n >= 2) {                         // label[0] = S, x5 = label[1]
            if (x5 == 5 * L) s_l = max(s_l, 0);
            if (labels) labels[b] = S;
        }
        int* out = summary + (size_t)b * 5;
        out[0] = s_l; out[1] = l_a; out[2] = a_p; out[3] = p_t; out[4] = cliffs;
    }
}

}  // namespace

// bptr: [B, N] uint8, read-major.  labels: [N, B] uint8 pre-filled with T
// by the caller, or NULL.
extern "C" int npt_launch_seg_backtrack(
        const uint8_t* bptr, int N, int B, const int* n, int* summary,
        uint8_t* labels, void* stream) {
    if (B > 0)
        seg_backtrack_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
            bptr, N, B, n, summary, labels);
    return (int)cudaGetLastError();
}
