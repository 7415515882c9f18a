// R9 profile-HMM Forward log-likelihood per segment with the reference's
// quantized logsum (NPT_LOGSUM=table).
//
// Replaces: the table route of the JAX scan, nanopolish_tpu/ops/
// profile_hmm.py _profile_hmm_scan with logsum="table" (:198), whose
// _kstate_scan runs the K chain as a sequential lax.scan (:165-176).  It
// is no Pallas kernel: the JAX package's Pallas Forwards have no table
// route.  Spec: profile_hmm_score_r9 (nanopolish_profile_hmm_r9.cpp:35-65)
// over the fill of nanopolish_profile_hmm_r9.inl:265-433, every sum
// p7_FLogsum (logsum.h:55-67: log(1 + e^-d) from a 16,000-entry table in
// 0.001-nat steps, max alone from 15.7 nats on), folded in the reference's
// order: the six M terms left to right, the K chain kmer after kmer from
// -inf, the end terms M, B, K then the running score.  Plain version:
// nanopolish_tpu_torch/ops/profile_hmm.py forward_fill_plain(logsum=
// "table").  No transcendental is evaluated on the card: the table is the
// host's (utils/logsum.py), uploaded by the wrapper.
//
// What bounds it on the H100: the dependent chain.  The table add is not
// associative, so the K chain of a row is serial in the kmers, and cell
// (t, k) needs (t, k-1), (t-1, k) and (t-1, k-1).  A row-by-row fill would
// take T K dependent lookups a segment.  Design: one warp per segment, an
// anti-diagonal wavefront over strips of 32 kmers.  Lane l of strip j holds
// kmer 32 j + l and at step s computes row s - l: the cell's left
// neighbour (t, k-1) comes from lane l-1 by __shfl_up_sync (computed one
// step earlier), its diagonal (t-1, k-1) is what the lane received the step
// before, and (t-1, k) is its own.  Lane 0 reads column 32 j - 1 from the
// strip boundary (global scratch, one float4 per row), which lane 31 of the
// previous strip wrote; lane 31 overwrites row t there only after its own
// row-t value, which depends through the K chain on lane 0's read of row
// t, is known, so one column serves every strip.  A segment takes
// (n_events + 31) ceil(n_kmers / 32) steps.  Every cell evaluates the
// plain version's expression on the same operands, so the bits are its.
// The table lives in shared memory (64,000 bytes), loaded once a block of
// NPT_TABLE_WARPS segments.  Built with -fmad=false: a*b+c is fused only
// where the scan fuses it (the emission, the soft-clip flanks), as in
// csrc/forward_fill.cu.

#include "forward_common.cuh"

namespace {

constexpr int NPT_TABLE_WARPS = 8;          // segments per block
constexpr int NPT_LOGSUM_TBL = 16000;       // utils/logsum.py P7_LOGSUM_TBL

// p7_FLogsum as utils/logsum.add_logs_table evaluates it: keep is false
// where min is -inf (d is inf or NaN) or d >= 15.7, and then max alone.
__device__ __forceinline__ float npt_logsum_table(float x, float y,
                                                  const float* tbl) {
    const float mx = npt_max(x, y);
    const float mn = x < y ? x : y;
    const float d = npt_sub(mx, mn);
    const bool keep = d < 15.7f;
    const int idx = keep ? min((int)npt_mul(d, 1000.0f), NPT_LOGSUM_TBL - 1)
                         : 0;
    const float v = tbl[idx];
    return keep ? npt_add(mx, v) : mx;
}

__global__ void __launch_bounds__(32 * NPT_TABLE_WARPS) forward_table_kernel(
        const float* __restrict__ lev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, int KP, const int* __restrict__ nev_a,
        const int* __restrict__ nk_a, const float* __restrict__ trans,
        const uint8_t* __restrict__ clips, float flank0, float clip_base,
        float clip_step, const float* __restrict__ table, int B,
        float* __restrict__ out, float4* __restrict__ bnd) {
    extern __shared__ float4 tbl4[];
    for (int i = threadIdx.x; i < NPT_LOGSUM_TBL / 4; i += blockDim.x)
        tbl4[i] = __ldg(reinterpret_cast<const float4*>(table) + i);
    __syncthreads();
    const float* tbl = reinterpret_cast<const float*>(tbl4);

    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * NPT_TABLE_WARPS + (threadIdx.x >> 5);
    if (b >= B) return;                  // the whole warp leaves together
    const int nev = nev_a[b];
    const int last = npt_clampi(nk_a[b] - 1, 0, KP - 1);
    const NptFwdParams p = npt_fwd_params(trans + (size_t)b * 8,
                                          clips + (size_t)b * 2, flank0,
                                          clip_base, clip_step);
    const float* levb = lev + (size_t)b * T;
    float4* col = bnd + (size_t)b * T;   // row t of column 32 j - 1 at t - 1
    const float NEG = npt_neg_inf();
    const int n_strips = last / 32 + 1;
    float lp_end = NEG;

    for (int j = 0; j < n_strips; ++j) {
        const int k = 32 * j + lane;
        const size_t kb = (size_t)b * KP + (k < KP ? k : 0);
        const float mu_k = mu[kb], sg_k = sig[kb], cc_k = cc[kb];
        const bool more = j + 1 < n_strips;
        // the last strip stops when the lane of kmer `last` ends its rows
        const int steps = nev + (more ? 31 : last - 32 * j);
        const bool edge = lane == 0 && j > 0;  // reads the boundary
        float M = NEG, Bv = NEG, Kv = NEG;      // (t-1, k)
        float Mp = NEG, Bp = NEG, Kp = NEG;     // (t-1, k-1)
        // row t's level and boundary cell, loaded one step ahead so that
        // their latency is off the chain
        float lv_t = 0.0f;
        float4 bnd_t = make_float4(NEG, NEG, NEG, 0.0f);
        if (lane == 0 && nev >= 1) {
            lv_t = __ldg(levb);
            if (edge) bnd_t = col[0];
        }
        for (int s = 1; s <= steps; ++s) {
            const int t = s - lane;
            const bool live = t >= 1 && t <= nev;
            const float lv = lv_t;
            const float4 bv = bnd_t;
            if (t + 1 >= 1 && t + 1 <= nev) {
                lv_t = __ldg(levb + t);
                if (edge) bnd_t = col[t];
            }
            // (t, k-1): the lane below's cell of the previous step
            float Mn = __shfl_up_sync(NPT_FULL_MASK, M, 1);
            float Bn = __shfl_up_sync(NPT_FULL_MASK, Bv, 1);
            float Kn = __shfl_up_sync(NPT_FULL_MASK, Kv, 1);
            if (lane == 0) {
                Mn = bv.x;
                Bn = bv.y;
                Kn = bv.z;
            }
            if (live) {
                const float em = npt_log_normal(lv, mu_k, sg_k, cc_k);
                // soft-clip entry into the first kmer (r9.inl:200-227)
                const float s_soft = (k == 0 && (p.pre_clip || t == 1))
                    ? npt_flank((float)(t - 1), p.flank0, p.clip_base,
                                p.clip_step)
                    : NEG;
                float m_in = npt_logsum_table(npt_add(p.lp_mm_self, M),
                                              npt_add(p.lp_mm_next, Mp), tbl);
                m_in = npt_logsum_table(m_in, npt_add(p.lp_b3, Bv), tbl);
                m_in = npt_logsum_table(m_in, npt_add(p.lp_b3, Bp), tbl);
                m_in = npt_logsum_table(m_in, npt_add(p.lp_km, Kp), tbl);
                m_in = npt_logsum_table(m_in, s_soft, tbl);
                const float M_new = npt_add(m_in, em);
                const float B_new = npt_logsum_table(
                    npt_add(p.lp_mb, M), npt_add(p.lp_bb, Bv), tbl);
                const float c = npt_logsum_table(npt_add(p.lp_mk, Mn),
                                                 npt_add(p.lp_b3, Bn), tbl);
                const float K_new = npt_logsum_table(
                    c, npt_add(Kn, p.lp_kk), tbl);
                // end contributions (r9.inl:385-396); lp_ms = 0
                if (k == last && (p.post_clip || t == nev)) {
                    const float s3 = npt_logsum_table(
                        npt_logsum_table(M_new, B_new, tbl), K_new, tbl);
                    const float post = npt_flank(
                        npt_sub((float)nev, (float)t), p.flank0, p.clip_base,
                        p.clip_step);
                    lp_end = npt_logsum_table(lp_end, npt_add(s3, post), tbl);
                }
                if (lane == 31 && more)
                    col[t - 1] = make_float4(M_new, B_new, K_new, 0.0f);
                M = M_new;
                Bv = B_new;
                Kv = K_new;
            }
            Mp = Mn;
            Bp = Bn;
            Kp = Kn;
        }
        __syncwarp();                    // the boundary column is written
    }
    if (lane == last % 32) out[b] = lp_end;
}

}  // namespace

// scratch: the strip boundary, [B, T] float4, or NULL when no segment has
// more than 32 kmers.  table: the 16,000 f32 of utils/logsum.py on the card.
extern "C" int npt_launch_forward_table(
        const float* lev, int T, const float* mu, const float* sig,
        const float* cc, int KP, const int* nev, const int* nk,
        const float* trans, const uint8_t* clips, float flank0,
        float clip_base, float clip_step, const float* table, int B,
        float* out, float* scratch, void* stream) {
    const size_t smem = (size_t)NPT_LOGSUM_TBL * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        forward_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (B > 0)
        forward_table_kernel<<<(B + NPT_TABLE_WARPS - 1) / NPT_TABLE_WARPS,
                               32 * NPT_TABLE_WARPS, smem,
                               (cudaStream_t)stream>>>(
            lev, T, mu, sig, cc, KP, nev, nk, trans, clips, flank0,
            clip_base, clip_step, table, B, out,
            reinterpret_cast<float4*>(scratch));
    return (int)cudaGetLastError();
}
