// Adaptive banded event alignment, fill (kernel 1 of the banded aligner).
//
// Replaces: nanopolish_tpu/ops/pallas_banded_exact.py _fill_kernel (:210).
// Spec: adaptive_banded_simple_event_align (nanopolish raw_loader.cpp:77-379);
// plain version: nanopolish_tpu_torch/ops/banded_align.py banded_fill_plain,
// which this kernel matches bit for bit.
//
// What bounds it on the H100: neither bytes (~33 B of trace per band, a few
// hundred MB per batch) nor f32 operations (~12 per cell) — the band loop is
// a serial dependency chain per read, so each read's time is bands x the
// latency of one band step.  The design keeps that step short:
//   * one warp per read, the 128-offset band across its 32 lanes, four
//     contiguous offsets per lane; the two previous bands live in registers;
//   * neighbour offsets come from one __shfl_up/__shfl_down per band row,
//     the Suzuki placement decision from two broadcasts of the band edges;
//   * the event and k-mer gathers for BOTH possible placements are issued
//     before the decision (five events and five k-mer triples per lane), so
//     their latency overlaps the shuffles instead of following them;
//   * moves are written as 2-bit codes, four cells per byte (one 32-byte
//     row per band, a single coalesced store), plus one placement byte.
// One warp per block spreads the batch over all SMs.

#include "npt_common.cuh"

namespace {

constexpr int BW = 100;     // band width (ALN_BANDWIDTH)
constexpr int HALF = 50;
constexpr int ROW_BYTES = 32;
constexpr int FROM_U = 1, FROM_L = 2;

__global__ void banded_fill_kernel(
        const float* __restrict__ ev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, int K,
        const int* __restrict__ nev_a, const int* __restrict__ nk_a,
        const float* __restrict__ lps_a, const float* __restrict__ lpt_a,
        float lp_skip, float lp_trim, int B, int n_bands,
        uint8_t* __restrict__ trace, uint8_t* __restrict__ moves,
        int* __restrict__ lle_out, int* __restrict__ beste_out,
        float* __restrict__ bests_out) {
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    if (b >= B) return;
    const float NEG = npt_neg_inf();
    const float* evb = ev + (size_t)b * T;
    const float* mub = mu + (size_t)b * K;
    const float* sgb = sig + (size_t)b * K;
    const float* ccb = cc + (size_t)b * K;
    uint8_t* trb = trace + (size_t)b * n_bands * ROW_BYTES;
    uint8_t* mvb = moves + (size_t)b * n_bands;
    const int nev = nev_a[b], nk = nk_a[b];
    const float lps = lps_a[b], lpt = lpt_a[b];
    const float nev_f = (float)nev;
    const int o0 = 4 * lane;

    // band 0: score 0 at the start cell (kmer -1, offset 50);
    // band 1 (a down move): first-event trim at offset 50
    float sp[4], sp2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        sp2[j] = (o0 + j == HALF) ? 0.0f : NEG;
        sp[j] = (o0 + j == HALF) ? lp_trim : NEG;
    }
    trb[lane] = 0;
    trb[ROW_BYTES + lane] = (o0 <= HALF && HALF < o0 + 4)
        ? (uint8_t)(FROM_U << (2 * (HALF - o0))) : 0;
    if (lane == 0) { mvb[0] = 0; mvb[1] = 0; }

    int ll_e = HALF, ll_k = -1 - HALF, r_prev = 0;
    float best_s = NEG;
    int best_e = 0;

    for (int bi = 2; bi < n_bands; ++bi) {
        // gathers for both placements: down puts event ll_e+1-o and kmer
        // ll_k+o at offset o, right puts event ll_e-o and kmer ll_k+1+o
        float evw[5], muw[5], sgw[5], ccw[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
            int e = npt_clampi(ll_e + 1 - o0 - j, 0, T - 1);
            int k = npt_clampi(ll_k + o0 + j, 0, K - 1);
            evw[j] = __ldg(evb + e);
            muw[j] = __ldg(mub + k);
            sgw[j] = __ldg(sgb + k);
            ccw[j] = __ldg(ccb + k);
        }

        // adaptive placement (raw_loader.cpp:175-195)
        const float ll = __shfl_sync(NPT_FULL_MASK, sp[0], 0);
        const float ur = __shfl_sync(NPT_FULL_MASK, sp[3], (BW - 1) / 4);
        float sp_next = __shfl_down_sync(NPT_FULL_MASK, sp[0], 1);
        float sp_prev = __shfl_up_sync(NPT_FULL_MASK, sp[3], 1);
        float s2_next = __shfl_down_sync(NPT_FULL_MASK, sp2[0], 1);
        float s2_prev = __shfl_up_sync(NPT_FULL_MASK, sp2[3], 1);
        if (lane == 31) { sp_next = NEG; s2_next = NEG; }
        if (lane == 0) { sp_prev = NEG; s2_prev = NEG; }
        const bool both_ob = (ll == NEG) && (ur == NEG);
        const int r = both_ob ? (bi & 1) : (ll < ur ? 1 : 0);
        ll_e += 1 - r;
        ll_k += r;
        const int amt = r_prev + r - 1;     // diag = sp2[o - 1 + r_prev + r]

        const float nxt[4] = {sp[1], sp[2], sp[3], sp_next};
        const float prv[4] = {sp_prev, sp[0], sp[1], sp[2]};
        const float nxt2[4] = {sp2[1], sp2[2], sp2[3], s2_next};
        const float prv2[4] = {s2_prev, sp2[0], sp2[1], sp2[2]};

        const int o_end = nk - 1 - ll_k;    // the band's last-kmer offset
        float cell[4];
        float end_val = NEG;
        uint32_t packed = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int o = o0 + j;
            const int ei = ll_e - o, ki = ll_k + o;
            const float up = r ? nxt[j] : sp[j];
            const float left = r ? sp[j] : prv[j];
            const float diag = amt == 1 ? nxt2[j] : (amt == 0 ? sp2[j] : prv2[j]);
            float cv = NEG;
            uint32_t code = 0;
            if (o < BW && ei >= 0 && ei < nev && ki >= 0 && ki < nk) {
                // window slot j + r, selected without a dynamic index so
                // the windows stay in registers
                const float em = npt_log_normal(r ? evw[j + 1] : evw[j],
                                                r ? muw[j + 1] : muw[j],
                                                r ? sgw[j + 1] : sgw[j],
                                                r ? ccw[j + 1] : ccw[j]);
                const float sd = npt_add(npt_add(diag, lpt), em);
                const float su = npt_add(npt_add(up, lps), em);
                const float sl = npt_add(left, lp_skip);
                const float m2 = npt_max(sd, su);
                code = (m2 == su) ? FROM_U : 0;
                const float m3 = npt_max(m2, sl);
                if (m3 == sl) code = FROM_L;
                cv = m3;
                if (o == o_end)   // trailing trim (raw_loader.cpp:313-324)
                    end_val = __fmaf_rn(npt_sub(nev_f, (float)ei), lp_trim, cv);
            } else if (ki == -1 && o < BW && ei >= 0 && ei < nev) {
                // trim column (raw_loader.cpp:215-225)
                cv = npt_mul(lp_trim, npt_add((float)ei, 1.0f));
                code = FROM_U;
            }
            cell[j] = cv;
            packed |= code << (2 * j);
        }
        if (o_end >= 0 && o_end < BW) {
            const float v = __shfl_sync(NPT_FULL_MASK, end_val, o_end >> 2);
            if (v > best_s) {                // strict: earliest event wins
                best_s = v;
                best_e = ll_e - o_end;
            }
        }
        trb[(size_t)bi * ROW_BYTES + lane] = (uint8_t)packed;
        if (lane == 0) mvb[bi] = (uint8_t)r;
#pragma unroll
        for (int j = 0; j < 4; ++j) { sp2[j] = sp[j]; sp[j] = cell[j]; }
        r_prev = r;
    }
    if (lane == 0) {
        lle_out[b] = ll_e;
        beste_out[b] = best_e;
        bests_out[b] = best_s;
    }
}

}  // namespace

extern "C" int npt_launch_banded_fill(
        const float* ev, int T, const float* mu, const float* sig,
        const float* cc, int K, const int* nev, const int* nk,
        const float* lps, const float* lpt, float lp_skip, float lp_trim,
        int B, int n_bands, uint8_t* trace, uint8_t* moves, int* lle,
        int* best_e, float* best_s, void* stream) {
    if (B > 0)
        banded_fill_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
            ev, T, mu, sig, cc, K, nev, nk, lps, lpt, lp_skip, lp_trim, B,
            n_bands, trace, moves, lle, best_e, best_s);
    return (int)cudaGetLastError();
}
