// R9 profile-HMM Forward log-likelihood per segment, from indexed inputs.
//
// Replaces: nanopolish_tpu/ops/pallas_profile_hmm.py _fwd_packed_kernel
// (:987), the Forward drain of variants (forward_packed, :1304).  Plain
// version: nanopolish_tpu_torch/ops/profile_hmm.py forward_indexed_plain.
//
// What it computes: one Forward score per segment, exactly as
// csrc/forward_fill.cu scores the segment's gathered flat inputs (the
// arithmetic of forward_common.cuh, which follows the JAX scan path and
// not the Pallas body).  A segment is four ids into inputs shared by many
// segments: an event row of levels_u [E, Tc], a read's table row of
// tabs [3, R, S] (mu, sigma, c), a kmer-rank row of rank_mat [U, Kc] and a
// transition row of trans_u [R2, 8].  The kernel gathers its levels and
// gaussians itself, so a flush uploads each unique piece once and the
// tables stay resident for all of its launches.
//
// What bounds it on the H100: operations, and the serial event rows.
// Each (event, kmer) cell costs nine logaddexps (an expf/log1pf pair and a
// few adds each); bytes are a few per segment, since the levels, ranks
// and tables are shared.  A segment's time is its rows' latency times the
// instructions its warp issues per row, so the design puts as few padding
// lanes and as few dependent tree levels in a row as the width allows:
//  - windows of up to 32 kmers (variants screening, 5-32 kmers): one
//    launch for all of a flush, each window on a group of 8 lanes of the
//    warp row of profile_hmm_row.cuh, 4 windows a warp, with R kmers a
//    lane at its own kmer width KP = 8 R (8, 16 or 32).  The host sorts
//    the windows by width, so three run ends passed as scalars say which
//    windows and which R each warp takes.  Every shuffle takes the width
//    argument 8, so the K chain's tree runs log2 R levels in registers
//    and 3 across lanes each way, and the first 8 lanes of a 32-lane tree
//    are the 8-lane tree: a score does not depend on the grouping.  Each
//    group loads its levels 8 rows at a time, one chunk ahead, and
//    broadcasts one per row (no row waits on a global load).  The windows
//    of a warp come sorted by event count; a group past its own last row
//    runs on in step (every lane joins every shuffle) and folds nothing
//    more into its score.  On an H100 8 lanes a window took 0.34 ms where
//    one lane per kmer took 0.44 on chip_smoke's 8,192 screening windows
//    (PERF.md);
//  - KP 64-128 (calling windows): the same row with W = 32 and R = KP / 32
//    kmers per lane (forward_fill.cu's warp kernel, with the indexed
//    gather in front);
//  - KP 256-1024: one block of KP threads per segment, the row loop
//    npt_forward_block (forward_common.cuh): at 256 it beat the warp row
//    on an H100 (2.25 against 2.87 ms on 394 calling windows);
//  - KP 2048 and wider: the wide row of profile_hmm_wide.cuh (a cluster
//    of up to 16 CTAs a segment when the flush has few).
// ops/profile_hmm_indexed.py indexed_layout picks the mode per width.
// The TPU kernel's lane-packed rows (pos/rev lane maps, segmented
// roll-scans) become the 8-lane groups.  Built with -fmad=false, so every
// mode equals forward_fill bit for bit.

#include "profile_hmm_wide.cuh"

namespace {

struct NptIndexedIds {
    const float* levb;
    int nev, nk, tab, rid;
};

__device__ __forceinline__ NptIndexedIds npt_indexed_ids(
        int s, const float* __restrict__ lev_u, int Tc,
        const int* __restrict__ nev_u, const int* __restrict__ nkm_u,
        const int* __restrict__ ids) {
    const int* id = ids + (size_t)s * 4;
    NptIndexedIds g;
    g.levb = lev_u + (size_t)id[0] * Tc;
    g.nev = nev_u[id[0]];
    g.tab = id[1];
    g.rid = id[2];
    g.nk = nkm_u[g.rid];
    return g;
}

// kmer k's gaussian of a segment (padding past n_kmers: mu 0, sigma 1,
// c of sigma 1)
struct NptIndexedGauss {
    const float* __restrict__ tabs;
    const int* __restrict__ ranks;       // the segment's rank row
    size_t tab_off, plane;               // tab * S, R * S
    int nk;
    float pad_c;
    __device__ __forceinline__ void operator()(int k, float& m, float& s,
                                               float& c) const {
        m = 0.0f;
        s = 1.0f;
        c = pad_c;
        if (k < nk) {
            const size_t r = tab_off + __ldg(ranks + k);
            m = __ldg(tabs + r);
            s = __ldg(tabs + plane + r);
            c = __ldg(tabs + 2 * plane + r);
        }
    }
};

__device__ __forceinline__ NptIndexedGauss npt_indexed_gauss(
        const NptIndexedIds& g, const float* __restrict__ tabs, int R, int S,
        const int* __restrict__ rank_mat, int Kc, float pad_c) {
    return NptIndexedGauss{tabs, rank_mat + (size_t)g.rid * Kc,
                           (size_t)g.tab * S, (size_t)R * S, g.nk, pad_c};
}

// The segments first + g (group g = lane / W of the warp) with R kmers
// per lane on groups of W lanes (KP = W R); a group at or past end stores
// nothing.
template <int R, int W>
__device__ __forceinline__ void npt_indexed_warp(
        int first, int end, const float* __restrict__ lev_u, int Tc,
        const int* __restrict__ nev_u, const float* __restrict__ tabs, int Rr,
        int S, const int* __restrict__ rank_mat, int Kc,
        const int* __restrict__ nkm_u, const float* __restrict__ trans_u,
        const int* __restrict__ ids, const uint8_t* __restrict__ clips,
        float flank0, float clip_base, float clip_step, float pad_c,
        float* __restrict__ out) {
    constexpr int KP = W * R;
    const int lane = threadIdx.x & 31;
    const int gl = lane & (W - 1);
    const int s = first + lane / W;
    const bool live = s < end;           // a group past end reads segment
    const int sc = live ? s : end - 1;   // end - 1 and stores nothing
    const NptIndexedIds g = npt_indexed_ids(sc, lev_u, Tc, nev_u, nkm_u, ids);
    const int nev = live ? g.nev : 0;
    const NptIndexedGauss gauss = npt_indexed_gauss(g, tabs, Rr, S, rank_mat,
                                                    Kc, pad_c);
    const NptFwdParams p = npt_fwd_params(
        trans_u + (size_t)ids[(size_t)sc * 4 + 3] * 8, clips + (size_t)sc * 2,
        flank0, clip_base, clip_step);
    NptRowLevels<W> lv(g.levb, nev, gl);
    NptRowLane<R> st;
#pragma unroll
    for (int r = 0; r < R; ++r) gauss(gl * R + r, st.mu[r], st.sg[r], st.cc[r]);
    npt_row_lane_start<R, W>(st, lv);
    // the warp runs to its longest segment's last row
    int t_end = nev;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
        t_end = max(t_end, __shfl_xor_sync(NPT_FULL_MASK, t_end, o));
    const int last = npt_clampi(g.nk - 1, 0, KP - 1);
    const int last_lane = last / R, last_r = last % R;
    float lp_end = npt_neg_inf();

    for (int t = 1; t <= t_end; ++t) {
        uint32_t unused[R];
        npt_row<R, NptLogSum, W>(t, gl, p, st, lv, unused);
        // end contributions (r9.inl:385-396); lp_ms = 0
        if (gl == last_lane && t <= nev && (p.post_clip || t == nev)) {
            float Ml = st.M[0], Bl = st.B[0], Kl = st.K[0];
#pragma unroll
            for (int r = 1; r < R; ++r)
                if (r == last_r) {
                    Ml = st.M[r];
                    Bl = st.B[r];
                    Kl = st.K[r];
                }
            const float s3 = npt_logaddexp(npt_logaddexp(Ml, Bl), Kl);
            const float post = npt_flank(npt_sub((float)nev, (float)t),
                                         p.flank0, p.clip_base, p.clip_step);
            lp_end = npt_logaddexp(lp_end, npt_add(s3, post));
        }
    }
    if (live && gl == last_lane) out[s] = lp_end;
}

#define NPT_INDEXED_ARGS                                                    \
    lev_u, Tc, nev_u, tabs, Rr, S, rank_mat, Kc, nkm_u, trans_u, ids, clips, \
        flank0, clip_base, clip_step, pad_c, out
#define NPT_INDEXED_PARAMS                                                  \
    const float* __restrict__ lev_u, int Tc, const int* __restrict__ nev_u, \
        const float* __restrict__ tabs, int Rr, int S,                      \
        const int* __restrict__ rank_mat, int Kc,                           \
        const int* __restrict__ nkm_u, const float* __restrict__ trans_u,   \
        const int* __restrict__ ids, const uint8_t* __restrict__ clips,     \
        float flank0, float clip_base, float clip_step, float pad_c,        \
        float* __restrict__ out

// The calling windows of 64 or 128 kmers: one segment a warp, R kmers a
// lane, NPT_ROW_WARPS warps per block.
template <int R>
__global__ void __launch_bounds__(32 * NPT_ROW_WARPS)
forward_indexed_warp_kernel(NPT_INDEXED_PARAMS, int n) {
    const int warp = blockIdx.x * NPT_ROW_WARPS + (threadIdx.x >> 5);
    if (warp >= n) return;               // the whole warp leaves together
    npt_indexed_warp<R, 32>(warp, n, NPT_INDEXED_ARGS);
}

// Windows of up to 32 kmers in one launch, 8 lanes a window and 4
// windows a warp: the segments [0, e8) are 8 kmers wide (1 a lane),
// [e8, e16) 16 (2 a lane) and [e16, n) 32 (4 a lane); each run starts a
// warp of its own.
__global__ void __launch_bounds__(32 * NPT_ROW_WARPS)
forward_indexed_narrow_kernel(NPT_INDEXED_PARAMS, int e8, int e16, int n) {
    int w = blockIdx.x * NPT_ROW_WARPS + (threadIdx.x >> 5);
    const int w8 = (e8 + 3) / 4, w16 = (e16 - e8 + 3) / 4;
    if (w < w8) {                        // the whole warp takes one branch
        npt_indexed_warp<1, 8>(4 * w, e8, NPT_INDEXED_ARGS);
        return;
    }
    w -= w8;
    if (w < w16) {
        npt_indexed_warp<2, 8>(e8 + 4 * w, e16, NPT_INDEXED_ARGS);
        return;
    }
    w -= w16;
    if (e16 + 4 * w < n)
        npt_indexed_warp<4, 8>(e16 + 4 * w, n, NPT_INDEXED_ARGS);
}

__global__ void forward_indexed_block_kernel(
        const float* __restrict__ lev_u, int Tc, const int* __restrict__ nev_u,
        const float* __restrict__ tabs, int R, int S,
        const int* __restrict__ rank_mat, int Kc,
        const int* __restrict__ nkm_u, const float* __restrict__ trans_u,
        const int* __restrict__ ids, const uint8_t* __restrict__ clips,
        float flank0, float clip_base, float clip_step, float pad_c, int KP,
        int n, float* __restrict__ out) {
    extern __shared__ float smem[];
    const int s = blockIdx.x;
    const int k = threadIdx.x;
    if (s >= n) return;
    const NptIndexedIds g = npt_indexed_ids(s, lev_u, Tc, nev_u, nkm_u, ids);
    float mu, sg, cc;
    npt_indexed_gauss(g, tabs, R, S, rank_mat, Kc, pad_c)(k, mu, sg, cc);
    const NptFwdParams p = npt_fwd_params(
        trans_u + (size_t)ids[(size_t)s * 4 + 3] * 8, clips + (size_t)s * 2,
        flank0, clip_base, clip_step);
    const int last = npt_clampi(g.nk - 1, 0, KP - 1);
    const float lp_end = npt_forward_block(g.levb, g.nev, mu, sg, cc, last, p,
                                           KP, smem);
    if (k == last) out[s] = lp_end;
}

template <bool kScratch, int U>
__global__ void __launch_bounds__(NPT_WIDE_MAX_THREADS)
forward_indexed_wide_kernel(
        const float* __restrict__ lev_u, int Tc, const int* __restrict__ nev_u,
        const float* __restrict__ tabs, int R, int S,
        const int* __restrict__ rank_mat, int Kc,
        const int* __restrict__ nkm_u, const float* __restrict__ trans_u,
        const int* __restrict__ ids, const uint8_t* __restrict__ clips,
        float flank0, float clip_base, float clip_step, float pad_c, int J,
        int C, float* __restrict__ out, float* __restrict__ scratch) {
    extern __shared__ float smem[];
    const int s = blockIdx.x / C;
    const int KP = J * ((int)blockDim.x - 32) * C;
    const NptIndexedIds g = npt_indexed_ids(s, lev_u, Tc, nev_u, nkm_u, ids);
    const NptIndexedGauss gauss = npt_indexed_gauss(g, tabs, R, S, rank_mat,
                                                    Kc, pad_c);
    const NptFwdParams p = npt_fwd_params(
        trans_u + (size_t)ids[(size_t)s * 4 + 3] * 8, clips + (size_t)s * 2,
        flank0, clip_base, clip_step);
    const int last = npt_clampi(g.nk - 1, 0, KP - 1);
    const float lp_end = npt_wide_fill<U, NptLogSum>(
        g.levb, g.nev, gauss, J, C, last, p, smem,
        npt_wide_rows<kScratch>(smem, scratch, J, false), nullptr);
    if (npt_wide_owns(last, J, C)) out[s] = lp_end;
}

template <int R>
int launch_warp(cudaStream_t st, NPT_INDEXED_PARAMS, int n) {
    forward_indexed_warp_kernel<R>
        <<<(n + NPT_ROW_WARPS - 1) / NPT_ROW_WARPS, 32 * NPT_ROW_WARPS, 0,
           st>>>(NPT_INDEXED_ARGS, n);
    return (int)cudaGetLastError();
}

}  // namespace

// The mode, from (KP, kpl) (ops/profile_hmm_indexed.py indexed_layout):
// KP 32, kpl 1: windows of up to 32 kmers, each at its own width 8, 16 or
// 32 as the run ends e8 <= e16 <= n say; KP = 32 kpl with kpl 2 or 4: the
// warp row; kpl 0: the block row (KP 32-1024 threads); KP past 1,024: the
// wide row at kpl kmers per thread, nt threads a CTA (nt - 32 kmer
// threads and the tree warp) and a cluster of C CTAs a segment (KP =
// kpl (nt - 32) C), whose row buffers are scratch
// (npt_wide_row_bytes a CTA) or, when scratch is NULL, shared memory.
extern "C" int npt_launch_forward_indexed(
        const float* lev_u, int Tc, const int* nev_u, const float* tabs,
        int Rr, int S, const int* rank_mat, int Kc, const int* nkm_u,
        const float* trans_u, const int* ids, const uint8_t* clips,
        float flank0, float clip_base, float clip_step, float pad_c, int KP,
        int kpl, int nt, int C, int n, float* out, float* scratch, int e8,
        int e16, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const int R = Rr;
    if (KP == 32 && kpl == 1) {
        if (!(0 <= e8 && e8 <= e16 && e16 <= n))
            return (int)cudaErrorInvalidValue;
        const int warps =
            (e8 + 3) / 4 + (e16 - e8 + 3) / 4 + (n - e16 + 3) / 4;
        forward_indexed_narrow_kernel<<<
            (warps + NPT_ROW_WARPS - 1) / NPT_ROW_WARPS, 32 * NPT_ROW_WARPS,
            0, st>>>(NPT_INDEXED_ARGS, e8, e16, n);
        return (int)cudaGetLastError();
    }
    if ((kpl == 2 || kpl == 4) && KP == 32 * kpl)
        return kpl == 2 ? launch_warp<2>(st, NPT_INDEXED_ARGS, n)
                        : launch_warp<4>(st, NPT_INDEXED_ARGS, n);
    if (kpl == 0 && KP >= 32 && KP <= 1024) {
        const size_t smem = (size_t)7 * KP * sizeof(float);
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                forward_indexed_block_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        forward_indexed_block_kernel<<<n, KP, smem, st>>>(
            lev_u, Tc, nev_u, tabs, R, S, rank_mat, Kc, nkm_u, trans_u, ids,
            clips, flank0, clip_base, clip_step, pad_c, KP, n, out);
        return (int)cudaGetLastError();
    }
    if (KP > 1024) {
        if (!npt_wide_geometry(KP, kpl, nt, C))
            return (int)cudaErrorInvalidValue;
        const size_t smem =
            npt_wide_smem(kpl * (nt - 32), false, scratch == nullptr);
        // U kmers of a thread at once in each loop of the row
        const auto kernel =
            kpl >= 4 ? (scratch ? forward_indexed_wide_kernel<true, 4>
                                : forward_indexed_wide_kernel<false, 4>)
            : kpl == 2 ? (scratch ? forward_indexed_wide_kernel<true, 2>
                                  : forward_indexed_wide_kernel<false, 2>)
                       : (scratch ? forward_indexed_wide_kernel<true, 1>
                                  : forward_indexed_wide_kernel<false, 1>);
        return npt_wide_launch(kernel, n, nt, C, smem, st, lev_u, Tc, nev_u,
                               tabs, R, S, rank_mat, Kc, nkm_u, trans_u, ids,
                               clips, flank0, clip_base, clip_step, pad_c,
                               kpl, C, out, scratch);
    }
    return (int)cudaErrorInvalidValue;
}
