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
// max-plus steps, so a read cannot be cut into parts (a max-plus scan over
// samples would regroup the f32 additions, and the scores and the
// strict-< backpointers would leave the plain version's bits).  The bytes
// are small (4 per sample in, 1 out); the bound is the chain: per sample
// ~4 dependent f32 operations on the P state (add, max, max, add), and
// ~45 instructions that one warp issues for the step (12 transition adds,
// the maxima, 8 comparisons and the byte).
// The design: one warp per read, SEG_WARPS reads per block.  The
// emissions do not depend on the chain, so the 32 lanes compute the six
// emissions of the next 32 samples, one sample per lane (its load issued
// one chunk ahead), and park them in shared memory; then every lane steps
// the chain through those 32 samples in step, reading each sample's six
// emissions with two broadcast loads that do not wait on the chain.  Step
// j's backpointer byte stays in lane j's register, and the warp writes the
// chunk's 32 bytes with one coalesced store: the backpointers are
// read-major [B, N] (csrc/seg_backtrack.cu reads them so).  Only the first
// and last chunks of a read carry the guards of sample 0 and of n.  One
// byte per (read, sample) holds the five live backpointers (S always
// points to S): bit 0 L<-L, bit 1 A<-A, bits 2-3 P's source (0 P, 1 A,
// 2 C), bit 4 C<-C, bit 5 T<-T.  The 512-read polya batch is 512 warps,
// about one per scheduler of the card's 132 SMs.

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

constexpr int SEG_WARPS = 4;        // reads per block

struct SegState { float S, L, A, P, C, T; };

// One step t (1 <= t < n) on the emissions e (s, l, a, p, c, t at e[0..5]):
// returns the backpointer byte and updates v.
__device__ __forceinline__ uint32_t seg_step(SegState& v, const float* lt,
                                             float4 e0, float2 e1) {
    const float s_s = npt_add(v.S, lt[SS]), s_l = npt_add(v.S, lt[SL]);
    const float l_l = npt_add(v.L, lt[LL]), l_a = npt_add(v.L, lt[LA]);
    const float a_a = npt_add(v.A, lt[AA]), a_p = npt_add(v.A, lt[AP]);
    const float p_p = npt_add(v.P, lt[PP]), p_c = npt_add(v.P, lt[PC]),
                p_t = npt_add(v.P, lt[PT]);
    const float c_c = npt_add(v.C, lt[CC]), c_p = npt_add(v.C, lt[CP]);
    const float t_t = npt_add(v.T, lt[TT]);
    // backpointers with the reference's strict-< tie rules
    const uint32_t bl = s_l < l_l;
    const uint32_t ba = l_a < a_a;
    const uint32_t bp = (a_p < p_p && c_p < p_p) ? 0u
                      : ((p_p < a_p && c_p < a_p) ? 1u : 2u);
    const uint32_t bc = p_c < c_c;
    const uint32_t bt = p_t < t_t;
    v.S = npt_add(s_s, e0.x);
    v.L = npt_add(npt_max(l_l, s_l), e0.y);
    v.A = npt_add(npt_max(a_a, l_a), e0.z);
    v.P = npt_add(npt_max(p_p, npt_max(a_p, c_p)), e0.w);
    v.C = npt_add(npt_max(c_c, p_c), e1.x);
    v.T = npt_add(npt_max(p_t, t_t), e1.y);
    return bl | (ba << 1) | (bp << 2) | (bc << 4) | (bt << 5);
}

// The chain through one chunk of 32 samples c0 ... c0 + 31, whose
// emissions sit in em (8 floats per sample); every lane runs it.  kGuard:
// the chunk holds sample 0 or reaches n, so steps outside 1 <= t < n are
// skipped.  Returns lane's byte (step c0 + lane).
template <bool kGuard>
__device__ __forceinline__ uint32_t seg_chunk(SegState& v, const float* lt,
                                              const float* em, int c0, int n,
                                              int lane) {
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const int t = c0 + j;
        if (kGuard && (t < 1 || t >= n)) continue;
        const float4 e0 = *reinterpret_cast<const float4*>(em + 8 * j);
        const float2 e1 = *reinterpret_cast<const float2*>(em + 8 * j + 4);
        const uint32_t byte = seg_step(v, lt, e0, e1);
        mine = lane == j ? byte : mine;
    }
    return mine;
}

__global__ void __launch_bounds__(32 * SEG_WARPS) seg_viterbi_fill_kernel(
        const float* __restrict__ samples, int N, int B,
        const int* __restrict__ n_a, const float* __restrict__ scal,
        const SegConsts k, uint8_t* __restrict__ bptr,
        float* __restrict__ vfin) {
    __shared__ __align__(16) float em_s[SEG_WARPS][32 * 8];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int b = blockIdx.x * SEG_WARPS + w;
    if (b >= B) return;                  // the whole warp leaves together
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
    float* em = em_s[w];
    // init with the LAST sample's emission (polya_estimator.cpp:385-387)
    const Emit e0 = emissions(samples[(size_t)max(n - 1, 0) * B + b], g, k);
    SegState v{e0.s, NEG, NEG, NEG, NEG, NEG};
    uint8_t* row = bptr + (size_t)b * N;
    auto load = [&](int t) {
        return t < n ? __ldg(samples + (size_t)t * B + b) : 100.0f;
    };
    float x_cur = load(lane), x_nxt = load(32 + lane);

    for (int c0 = 0; c0 < n; c0 += 32) {
        const Emit e = emissions(x_cur, g, k);          // sample c0 + lane
        x_cur = x_nxt;
        x_nxt = load(c0 + 64 + lane);
        __syncwarp();                    // the last chunk's reads are done
        *reinterpret_cast<float4*>(em + 8 * lane) =
            make_float4(e.s, e.l, e.a, e.p);
        *reinterpret_cast<float2*>(em + 8 * lane + 4) = make_float2(e.c, e.t);
        __syncwarp();
        const uint32_t mine = (c0 == 0 || c0 + 32 > n)
            ? seg_chunk<true>(v, lt, em, c0, n, lane)
            : seg_chunk<false>(v, lt, em, c0, n, lane);
        const int t = c0 + lane;
        if (t >= 1 && t < n) row[t] = (uint8_t)mine;
    }
    if (lane == 0) {
        float* out = vfin + (size_t)b * 6;
        out[0] = v.S; out[1] = v.L; out[2] = v.A; out[3] = v.P; out[4] = v.C;
        out[5] = v.T;
    }
}

}  // namespace

// consts: host pointer to the 48 f32 of seg_constants, copied into the
// kernel's parameters.  bptr [B, N], read-major, must be zeroed by the
// caller (sample 0 and the samples past each read's length stay 0).
extern "C" int npt_launch_seg_viterbi_fill(
        const float* samples, int N, int B, const int* n, const float* scal,
        const float* consts, uint8_t* bptr, float* vfin, void* stream) {
    SegConsts k;
    for (int i = 0; i < N_CONSTS; ++i) k.k[i] = consts[i];
    if (B > 0)
        seg_viterbi_fill_kernel<<<(B + SEG_WARPS - 1) / SEG_WARPS,
                                  32 * SEG_WARPS, 0, (cudaStream_t)stream>>>(
            samples, N, B, n, scal, k, bptr, vfin);
    return (int)cudaGetLastError();
}
