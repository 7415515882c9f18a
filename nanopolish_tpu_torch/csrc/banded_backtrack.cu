// Adaptive banded event alignment, backtrack (kernel 2 of the banded aligner).
//
// Replaces: nanopolish_tpu/ops/pallas_banded_exact.py _backtrack_kernel
// (:441) and the base->event scatter _b2e_from_pairs (:739).
// Spec: raw_loader.cpp:302-362 (walk) and squiggle_read.cpp:284-299
// (distinct-event base->event rule); plain version:
// nanopolish_tpu_torch/ops/banded_align.py banded_backtrack_plain, which
// this kernel matches bit for bit (the summed emission is accumulated in
// the same walk order).
//
// What bounds it on the H100: the walk is one serial chain per read whose
// next cell depends on the move just read, so it is bound by the latency of
// one step, not by the ~33 B per band it reads.  A chain of dependent
// global loads would cost a device-memory round trip per step; instead the
// read's warp stages the next 32 bands of trace rows and placement bits,
// and the 32-event / 32-kmer windows the walk can reach within them, into
// shared memory with coalesced loads, and lane 0 walks from there.  The
// base->event map is written directly: the walk visits each kmer's events
// contiguously and in decreasing order, so the first map-valid visit is the
// kmer's last event and the final one its first event.

#include "npt_common.cuh"

namespace {

constexpr int ROW_BYTES = 32;
constexpr int CH = 32;          // bands staged per chunk (one per lane)
constexpr int LANES = 128;
constexpr int FROM_D = 0, FROM_U = 1, FROM_L = 2;
constexpr int INT32_MAX_ = 2147483647;

__global__ void banded_backtrack_kernel(
        const uint8_t* __restrict__ trace, const uint8_t* __restrict__ moves,
        const int* __restrict__ lle_last, const int* __restrict__ best_e_a,
        const float* __restrict__ ev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, int K, const int* __restrict__ nk_a,
        int B, int n_bands, int* __restrict__ b2e_start,
        int* __restrict__ b2e_stop, float* __restrict__ sum_em_out,
        int* __restrict__ stats_out) {
    __shared__ __align__(16) uint8_t tr_s[CH][ROW_BYTES];
    __shared__ uint8_t mv_s[CH];
    __shared__ float ev_s[CH], mu_s[CH], sg_s[CH], cc_s[CH];

    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    if (b >= B) return;
    const uint8_t* trb = trace + (size_t)b * n_bands * ROW_BYTES;
    const uint8_t* mvb = moves + (size_t)b * n_bands;
    const float* evb = ev + (size_t)b * T;
    const float* mub = mu + (size_t)b * K;
    const float* sgb = sig + (size_t)b * K;
    const float* ccb = cc + (size_t)b * K;
    int* sb = b2e_start + (size_t)b * K;
    int* tb = b2e_stop + (size_t)b * K;
    for (int k = lane; k < K; k += 32) { sb[k] = -1; tb[k] = -1; }

    // walk state (meaningful in lane 0; ki/ei broadcast per chunk)
    int ki = nk_a[b] - 1, ei = best_e_a[b], ll_e = lle_last[b];
    bool active = true;
    float sum_em = 0.0f;
    int n_pairs = 0, cur_gap = 0, max_gap = 0;
    int min_ev = INT32_MAX_, max_ev = -1, last_ki = -1, last_map_ki = -1;

    for (int hi = n_bands - 1; hi >= 0; hi -= CH) {
        const int lo = hi - CH + 1 < 0 ? 0 : hi - CH + 1;
        const int ki0 = __shfl_sync(NPT_FULL_MASK, ki, 0);
        const int ei0 = __shfl_sync(NPT_FULL_MASK, ei, 0);
        __syncwarp();
        if (lo + lane <= hi) {
            const uint4* src = reinterpret_cast<const uint4*>(
                trb + (size_t)(lo + lane) * ROW_BYTES);
            uint4* dst = reinterpret_cast<uint4*>(tr_s[lane]);
            dst[0] = src[0];
            dst[1] = src[1];
            mv_s[lane] = mvb[lo + lane];
        }
        // windows: entry j holds event ei0 - j and kmer ki0 - j
        const int e = npt_clampi(ei0 - lane, 0, T - 1);
        const int k = npt_clampi(ki0 - lane, 0, K - 1);
        ev_s[lane] = evb[e];
        mu_s[lane] = mub[k];
        sg_s[lane] = sgb[k];
        cc_s[lane] = ccb[k];
        __syncwarp();
        if (lane == 0) {
            for (int bi = hi; bi >= lo; --bi) {
                if (active && ei + ki + 2 == bi) {
                    const int off = npt_clampi(ll_e - ei, 0, LANES - 1);
                    const int mv = (tr_s[bi - lo][off >> 2] >> (2 * (off & 3))) & 3;
                    // emission at the visited cell (raw_loader.cpp:339-342)
                    const int je = npt_clampi(ei0 - ei, 0, CH - 1);
                    const int jk = npt_clampi(ki0 - ki, 0, CH - 1);
                    const float lp = npt_log_normal(ev_s[je], mu_s[jk], sg_s[jk], cc_s[jk]);
                    sum_em = npt_add(sum_em, lp);
                    n_pairs += 1;
                    min_ev = ei < min_ev ? ei : min_ev;
                    max_ev = ei > max_ev ? ei : max_ev;
                    last_ki = ki;
                    const bool is_d = mv == FROM_D, is_u = mv == FROM_U, is_l = mv == FROM_L;
                    cur_gap = is_l ? cur_gap + 1 : 0;
                    max_gap = cur_gap > max_gap ? cur_gap : max_gap;
                    const bool term = ((is_u ? ki : ki - 1) < 0) || ((is_l ? ei : ei - 1) < 0);
                    if (!is_l || term) {
                        if (ki != last_map_ki) { tb[ki] = ei; last_map_ki = ki; }
                        sb[ki] = ei;
                    }
                    if (is_d || is_l) ki -= 1;
                    if (is_d || is_u) ei -= 1;
                    if (term) active = false;
                }
                ll_e -= 1 - mv_s[bi - lo];
            }
        }
        __syncwarp();
    }
    if (lane == 0) {
        sum_em_out[b] = sum_em;
        int* st = stats_out + (size_t)b * 5;
        st[0] = n_pairs;
        st[1] = max_gap;
        st[2] = last_ki;
        st[3] = min_ev;
        st[4] = max_ev;
    }
}

}  // namespace

extern "C" int npt_launch_banded_backtrack(
        const uint8_t* trace, const uint8_t* moves, const int* lle,
        const int* best_e, const float* ev, int T, const float* mu,
        const float* sig, const float* cc, int K, const int* nk, int B,
        int n_bands, int* b2e_start, int* b2e_stop, float* sum_em,
        int* stats, void* stream) {
    if (B > 0)
        banded_backtrack_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
            trace, moves, lle, best_e, ev, T, mu, sig, cc, K, nk, B, n_bands,
            b2e_start, b2e_stop, sum_em, stats);
    return (int)cudaGetLastError();
}
