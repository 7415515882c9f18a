// Segmentation Viterbi fill: the 6-state (S, L, A, P, C, T) sample-level
// HMM of polya and detect-polyi.
//
// Replaces: nanopolish_tpu/ops/pallas_segmentation.py _seg_fwd_kernel
// (:101).  Spec: SegmentationHMM (nanopolish_polya_estimator.cpp:176-520)
// as the JAX scan path computes it (segmentation_hmm.py:83-169); plain
// version: nanopolish_tpu_torch/ops/segmentation_hmm.py
// seg_viterbi_fill_plain, which this kernel matches bit for bit (every
// constant is rounded to f32 on the host, every operation rounds once,
// expf/logf are the ones torch.exp/torch.log call on the card).
//
// What bounds it on the H100: each read is a chain of n dependent 6-state
// max-plus steps.  The bytes are small (4 per sample in, 1 out) and so
// are the operations (~100 f32 operations per sample for the emissions),
// so the bound is the latency of the chain.  The design: one thread per
// read, the six scores in registers, each thread looping to its own n
// (no padded power-of-two buckets); samples and backpointers are
// sample-major [N, B], so a warp's loads and stores coalesce across
// reads.  The emissions do not depend on the chain, which leaves the
// compiler free to overlap the next sample's emission with this step's
// max/add.  One byte per (sample, read) holds the five live
// backpointers (S always points to S): bit 0 L<-L, bit 1 A<-A, bits 2-3
// P's source (0 P, 1 A, 2 C), bit 4 C<-C, bit 5 T<-T.  Reads should come
// longest first, so the threads of a warp end together.

#include "npt_common.cuh"

namespace {

constexpr int N_CONSTS = 48;
struct SegConsts { float k[N_CONSTS]; };

// seg_constants layout (ops/segmentation_hmm.py)
constexpr int G_S = 0, G_L = 1, G_A0 = 2, G_A1 = 3, G_P = 4, G_P1 = 5,
              G_T0 = 6, G_T1 = 7;
constexpr int K_S_NORM = 16, K_S_UNIF = 17, K_A0 = 18, K_A1 = 19, K_P0 = 20,
              K_P1 = 21, K_T0 = 22, K_T1 = 23, K_C_BEGIN = 24, K_C_END = 25,
              K_C_LOG = 26, K_LT = 27, K_DPI = 39, K_SQRT_2PI = 40,
              K_HALF_LOG_2PI = 41;
// the twelve log transitions at K_LT + j
constexpr int SS = 0, SL = 1, LL = 2, LA = 3, AA = 4, AP = 5, PP = 6, PC = 7,
              PT = 8, CC = 9, CP = 10, TT = 11;
constexpr float NEG = -1.0e30f;

struct Gauss { float mu, sd, den, logsd; };

__device__ __forceinline__ float norm_pdf(float xx, const Gauss& g) {
    const float z = npt_div(npt_sub(xx, g.mu), g.sd);
    return npt_div(expf(npt_mul(npt_mul(-0.5f, z), z)), g.den);
}

__device__ __forceinline__ float log_norm_pdf(float xx, const Gauss& g,
                                              float half_log_2pi) {
    const float z = npt_div(npt_sub(xx, g.mu), g.sd);
    return npt_sub(npt_sub(npt_mul(npt_mul(-0.5f, z), z), g.logsd),
                   half_log_2pi);
}

struct Emit { float s, l, a, p, c, t; };

__device__ __forceinline__ Emit emissions(float x, const Gauss* g,
                                          const SegConsts& k) {
    const float xx = (x > 200.0f || x < 40.0f) ? 100.0f : x;
    Emit e;
    e.s = logf(npt_add(npt_mul(k.k[K_S_NORM], norm_pdf(xx, g[G_S])),
                       k.k[K_S_UNIF]));
    e.l = log_norm_pdf(xx, g[G_L], k.k[K_HALF_LOG_2PI]);
    e.a = logf(npt_add(npt_mul(k.k[K_A0], norm_pdf(xx, g[G_A0])),
                       npt_mul(k.k[K_A1], norm_pdf(xx, g[G_A1]))));
    e.p = k.k[K_DPI] != 0.0f
        ? logf(npt_add(npt_mul(k.k[K_P0], norm_pdf(xx, g[G_P])),
                       npt_mul(k.k[K_P1], norm_pdf(xx, g[G_P1]))))
        : log_norm_pdf(xx, g[G_P], k.k[K_HALF_LOG_2PI]);
    e.c = (xx > k.k[K_C_BEGIN] && xx < k.k[K_C_END]) ? k.k[K_C_LOG]
                                                     : npt_neg_inf();
    e.t = logf(npt_add(npt_mul(k.k[K_T0], norm_pdf(xx, g[G_T0])),
                       npt_mul(k.k[K_T1], norm_pdf(xx, g[G_T1]))));
    return e;
}

__global__ void seg_viterbi_fill_kernel(
        const float* __restrict__ samples, int N, int B,
        const int* __restrict__ n_a, const float* __restrict__ scal,
        const SegConsts k, uint8_t* __restrict__ bptr,
        float* __restrict__ vfin) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int n = min(n_a[b], N);
    const float scale = scal[3 * b], shift = scal[3 * b + 1],
                var = scal[3 * b + 2];
    Gauss g[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        g[i].mu = npt_add(shift, npt_mul(scale, k.k[2 * i]));
        g[i].sd = npt_mul(var, k.k[2 * i + 1]);
        g[i].den = npt_mul(g[i].sd, k.k[K_SQRT_2PI]);
        g[i].logsd = logf(g[i].sd);
    }
    const float* lt = k.k + K_LT;
    // init with the LAST sample's emission (polya_estimator.cpp:385-387)
    const Emit e0 = emissions(samples[(size_t)max(n - 1, 0) * B + b], g, k);
    float vS = e0.s, vL = NEG, vA = NEG, vP = NEG, vC = NEG, vT = NEG;

    for (int t = 1; t < n; ++t) {
        const Emit e = emissions(samples[(size_t)t * B + b], g, k);
        const float s_s = npt_add(vS, lt[SS]), s_l = npt_add(vS, lt[SL]);
        const float l_l = npt_add(vL, lt[LL]), l_a = npt_add(vL, lt[LA]);
        const float a_a = npt_add(vA, lt[AA]), a_p = npt_add(vA, lt[AP]);
        const float p_p = npt_add(vP, lt[PP]), p_c = npt_add(vP, lt[PC]),
                    p_t = npt_add(vP, lt[PT]);
        const float c_c = npt_add(vC, lt[CC]), c_p = npt_add(vC, lt[CP]);
        const float t_t = npt_add(vT, lt[TT]);
        // backpointers with the reference's strict-< tie rules
        const int bl = s_l < l_l;
        const int ba = l_a < a_a;
        const int bp = (a_p < p_p && c_p < p_p) ? 0
                     : ((p_p < a_p && c_p < a_p) ? 1 : 2);
        const int bc = p_c < c_c;
        const int bt = p_t < t_t;
        bptr[(size_t)t * B + b] =
            (uint8_t)(bl | (ba << 1) | (bp << 2) | (bc << 4) | (bt << 5));
        vS = npt_add(s_s, e.s);
        vL = npt_add(npt_max(l_l, s_l), e.l);
        vA = npt_add(npt_max(a_a, l_a), e.a);
        vP = npt_add(npt_max(p_p, npt_max(a_p, c_p)), e.p);
        vC = npt_add(npt_max(c_c, p_c), e.c);
        vT = npt_add(npt_max(p_t, t_t), e.t);
    }
    float* out = vfin + (size_t)b * 6;
    out[0] = vS; out[1] = vL; out[2] = vA; out[3] = vP; out[4] = vC; out[5] = vT;
}

}  // namespace

// consts: host pointer to the 48 f32 of seg_constants, copied into the
// kernel's parameters.  bptr must be zeroed by the caller (row 0 and the
// rows past each read's length stay 0).
extern "C" int npt_launch_seg_viterbi_fill(
        const float* samples, int N, int B, const int* n, const float* scal,
        const float* consts, uint8_t* bptr, float* vfin, void* stream) {
    SegConsts k;
    for (int i = 0; i < N_CONSTS; ++i) k.k[i] = consts[i];
    if (B > 0)
        seg_viterbi_fill_kernel<<<(B + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
            samples, N, B, n, scal, k, bptr, vfin);
    return (int)cudaGetLastError();
}
