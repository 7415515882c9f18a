// Adaptive banded event alignment, fill (kernel 1 of the banded aligner).
//
// Replaces: nanopolish_tpu/ops/pallas_banded_exact.py _fill_kernel (:210).
// Spec: adaptive_banded_simple_event_align (nanopolish raw_loader.cpp:77-379);
// plain version: nanopolish_tpu_torch/ops/banded_align.py banded_fill_plain,
// which this kernel matches bit for bit.
//
// What bounds it on the H100: neither bytes (~33 B of trace per band, a few
// hundred MB per batch) nor f32 operations (~12 per cell): the band loop is
// a serial dependency chain per read, so each read's time is bands x the
// latency of one band step.  A warp that also gathers each band's events
// and k-mers and divides for its emissions waits on all of that every band.
//
// The design takes everything that does not depend on a DP score off the
// chain.  Band bi is the anti-diagonal e + k = bi - 2, so a cell's emission
// depends only on (bi, k), and the band's placement decides only which k
// range it covers.  Each block (one read) has two roles:
//   * the chain warp (warp 0) keeps the band recurrence as it was: four
//     contiguous offsets a lane, the two previous bands in registers,
//     neighbour offsets by __shfl_up/__shfl_down, the Suzuki placement from
//     two broadcasts of the band edges.  Per band it reads the five
//     emissions its lane may need for BOTH placements from shared memory,
//     before the placement decision, and writes the 2-bit moves (one
//     32-byte row per band) and the placement byte.  It evaluates every
//     cell and selects by the rules, with no branch; a band whose both
//     placements lie inside the read, clear of the trim column and of the
//     last kmer (nearly every band of a long read) skips the edge rules;
//   * PRODUCERS producer warps fill a ring of emissions: two chunks of
//     LOOKAHEAD bands, each band a slot of SPAN emissions over kmers
//     kb + t (t < SPAN), where kb is the chain's ll_k at the end of the
//     chunk before the previous one.  ll_k only grows, by at most one a
//     band, so the 100 offsets of every placement a chunk's bands can take
//     lie in kb .. kb + 2 LOOKAHEAD + 99 < kb + SPAN.  A producer gathers
//     events and k-mers along the anti-diagonal (contiguous, so coalesced)
//     and evaluates npt_log_normal there, with its division.
// The roles meet on named barriers once per chunk: FULL (the producers
// filled a chunk) and EMPTY (the chain is done with one and has written
// the kb that the chunk after next uses).
//
// What is left is the chain warp's own issue: ~170 instructions a band
// on one warp (~340 cycles a band on an H100; PERF.md).  Timed on the card
// against this design: one or two producer warps (the producers then bound
// it), a 30-band lookahead, and computing both placements' cells before
// the decision (no faster: the warp is issue-bound, not latency-bound).
//
// Bits: every emission is the same npt_log_normal on the same four floats
// (indices clamped as before; a clamped cell is never valid), only on
// another warp; the chain adds, maxes and compares in the order of
// banded_fill_plain, with the strict > for best_s and the trailing trim's
// one __fmaf_rn, as before.  Slot t sits at t + t / 4, so the chain's
// reads (lane l at 4 l + j) fall in distinct banks.

#include "npt_common.cuh"

namespace {

constexpr int BW = 100;     // band width (ALN_BANDWIDTH)
constexpr int HALF = 50;
constexpr int ROW_BYTES = 32;
constexpr int FROM_U = 1, FROM_L = 2;
constexpr int LOOKAHEAD = 14;                // bands per chunk
constexpr int SPAN = BW + 2 * LOOKAHEAD;     // kmers a band's slot holds
constexpr int SLOT = SPAN + SPAN / 4;        // floats a slot takes, padded
constexpr int PRODUCERS = 3;                 // producer warps per block
constexpr int THREADS = 32 * (1 + PRODUCERS);
constexpr int BAR_FULL = 1, BAR_EMPTY = 3;   // + the chunk's buffer
static_assert(SPAN % 32 == 0, "a producer lane fills SPAN / 32 kmers");

__device__ __forceinline__ int slot_at(int t) { return t + (t >> 2); }

__device__ void produce(float (*ring)[LOOKAHEAD][SLOT], const int* kbase,
                        const float* __restrict__ evb, int T,
                        const float* __restrict__ mub,
                        const float* __restrict__ sgb,
                        const float* __restrict__ ccb, int K, int n_bands,
                        int n_chunks, int pw, int lane) {
    for (int c = 0; c < n_chunks; ++c) {
        const int buf = c & 1;
        if (c >= 2) npt_bar_sync(BAR_EMPTY + buf, THREADS);
        const int kb = kbase[buf];
        const int b0 = 2 + c * LOOKAHEAD;
        const int nb = min(LOOKAHEAD, n_bands - b0);
        for (int s = pw; s < nb; s += PRODUCERS) {
            float* slot = ring[buf][s];
#pragma unroll
            for (int i = 0; i < SPAN / 32; ++i) {
                const int t = lane + 32 * i;
                const int e = npt_clampi(b0 + s - 2 - kb - t, 0, T - 1);
                const int k = npt_clampi(kb + t, 0, K - 1);
                slot[slot_at(t)] = npt_log_normal(__ldg(evb + e), __ldg(mub + k),
                                                  __ldg(sgb + k), __ldg(ccb + k));
            }
        }
        npt_bar_arrive(BAR_FULL + buf, THREADS);
    }
}

// the chain's state: the last two bands' scores (four offsets a lane),
// the last band's lower-left cell and placement, the best end so far
struct Chain {
    float sp[4], sp2[4];
    int ll_e, ll_k, r_prev;
    float best_s;
    int best_e;
};

// one band of the chain.  EDGE applies the rules of the read's edges:
// cells outside the read, the trim column (kmer -1) and the trailing trim
// of the last kmer; without it every offset below 100 is a valid cell,
// which holds when the caller has checked that both placements keep the
// band inside the read and clear of both.  Either way, every cell is
// evaluated and the rules select its value: no branch, so the four
// offsets' chains interleave.
template <bool EDGE>
__device__ __forceinline__ void band(
        Chain& ch, const float* slot, int kb, int bi, int lane, int nev,
        int nk, float nev_f, float lps, float lpt, float lp_skip,
        float lp_trim, uint8_t* trb, uint8_t* mvb) {
    const float NEG = npt_neg_inf();
    const int o0 = 4 * lane;
    const bool lane_in = lane < (BW + 3) / 4;   // offsets o0 .. o0 + 3 < 100
    // emissions for both placements: down puts kmer ll_k + o at offset o
    // (slot j), right puts ll_k + 1 + o there (slot j + 1); lanes past
    // offset 100 read slot 0, which they never use
    const int t0 = lane_in ? ch.ll_k - kb + o0 : 0;
    float emw[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) emw[j] = slot[slot_at(t0 + j)];

    // adaptive placement (raw_loader.cpp:175-195)
    const float ll = __shfl_sync(NPT_FULL_MASK, ch.sp[0], 0);
    const float ur = __shfl_sync(NPT_FULL_MASK, ch.sp[3], (BW - 1) / 4);
    float sp_next = __shfl_down_sync(NPT_FULL_MASK, ch.sp[0], 1);
    float sp_prev = __shfl_up_sync(NPT_FULL_MASK, ch.sp[3], 1);
    float s2_next = __shfl_down_sync(NPT_FULL_MASK, ch.sp2[0], 1);
    float s2_prev = __shfl_up_sync(NPT_FULL_MASK, ch.sp2[3], 1);
    sp_next = lane == 31 ? NEG : sp_next;
    s2_next = lane == 31 ? NEG : s2_next;
    sp_prev = lane == 0 ? NEG : sp_prev;
    s2_prev = lane == 0 ? NEG : s2_prev;
    const bool both_ob = (ll == NEG) && (ur == NEG);
    const int r = both_ob ? (bi & 1) : (ll < ur ? 1 : 0);
    ch.ll_e += 1 - r;
    ch.ll_k += r;
    const int amt = ch.r_prev + r - 1;   // diag = sp2[o - 1 + r_prev + r]

    const float nxt[4] = {ch.sp[1], ch.sp[2], ch.sp[3], sp_next};
    const float prv[4] = {sp_prev, ch.sp[0], ch.sp[1], ch.sp[2]};
    const float nxt2[4] = {ch.sp2[1], ch.sp2[2], ch.sp2[3], s2_next};
    const float prv2[4] = {s2_prev, ch.sp2[0], ch.sp2[1], ch.sp2[2]};

    const int o_end = nk - 1 - ch.ll_k;   // the band's last-kmer offset
    float cell[4];
    float end_val = NEG;
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int o = o0 + j;
        const int ei = ch.ll_e - o, ki = ch.ll_k + o;
        const bool in_e = o < BW && (unsigned)ei < (unsigned)nev;
        const bool valid = EDGE ? in_e && (unsigned)ki < (unsigned)nk : lane_in;
        const float up = r ? nxt[j] : ch.sp[j];
        const float left = r ? ch.sp[j] : prv[j];
        const float diag = amt == 1 ? nxt2[j] : (amt == 0 ? ch.sp2[j] : prv2[j]);
        // slot j + r, selected without a dynamic index so the five stay in
        // registers
        const float em = r ? emw[j + 1] : emw[j];
        const float sd = npt_add(npt_add(diag, lpt), em);
        const float su = npt_add(npt_add(up, lps), em);
        const float sl = npt_add(left, lp_skip);
        const float m2 = npt_max(sd, su);
        const float m3 = npt_max(m2, sl);
        const uint32_t code = m3 == sl ? FROM_L : (m2 == su ? FROM_U : 0);
        if (EDGE) {
            // trim column (raw_loader.cpp:215-225)
            const bool trim = in_e && ki == -1;
            const float tv = npt_mul(lp_trim, npt_add((float)ei, 1.0f));
            cell[j] = valid ? m3 : (trim ? tv : NEG);
            packed |= (valid ? code : (trim ? FROM_U : 0)) << (2 * j);
            // trailing trim (raw_loader.cpp:313-324)
            const float ev_end = __fmaf_rn(npt_sub(nev_f, (float)ei), lp_trim, m3);
            end_val = valid && o == o_end ? ev_end : end_val;
        } else {
            cell[j] = valid ? m3 : NEG;
            packed |= (valid ? code : 0) << (2 * j);
        }
    }
    if (EDGE) {
        const float v = __shfl_sync(NPT_FULL_MASK, end_val, (o_end >> 2) & 31);
        // strict: the earliest event wins
        const bool better = o_end >= 0 && o_end < BW && v > ch.best_s;
        ch.best_s = better ? v : ch.best_s;
        ch.best_e = better ? ch.ll_e - o_end : ch.best_e;
    }
    trb[(size_t)bi * ROW_BYTES + lane] = (uint8_t)packed;
    if (lane == 0) mvb[bi] = (uint8_t)r;
#pragma unroll
    for (int j = 0; j < 4; ++j) { ch.sp2[j] = ch.sp[j]; ch.sp[j] = cell[j]; }
    ch.r_prev = r;
}

__global__ void __launch_bounds__(THREADS) banded_fill_kernel(
        const float* __restrict__ ev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, int K,
        const int* __restrict__ nev_a, const int* __restrict__ nk_a,
        const float* __restrict__ lps_a, const float* __restrict__ lpt_a,
        float lp_skip, float lp_trim, int B, int n_bands,
        uint8_t* __restrict__ trace, uint8_t* __restrict__ moves,
        int* __restrict__ lle_out, int* __restrict__ beste_out,
        float* __restrict__ bests_out) {
    __shared__ float ring[2][LOOKAHEAD][SLOT];
    __shared__ int kbase[2];
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (b >= B) return;
    const int n_chunks = (n_bands - 2 + LOOKAHEAD - 1) / LOOKAHEAD;
    if (threadIdx.x == 0) kbase[0] = kbase[1] = -1 - HALF;
    __syncthreads();
    if (warp > 0) {
        produce(ring, kbase, ev + (size_t)b * T, T, mu + (size_t)b * K,
                sig + (size_t)b * K, cc + (size_t)b * K, K, n_bands,
                n_chunks, warp - 1, lane);
        return;
    }

    const float NEG = npt_neg_inf();
    uint8_t* trb = trace + (size_t)b * n_bands * ROW_BYTES;
    uint8_t* mvb = moves + (size_t)b * n_bands;
    const int nev = nev_a[b], nk = nk_a[b];
    const float lps = lps_a[b], lpt = lpt_a[b];
    const float nev_f = (float)nev;
    const int o0 = 4 * lane;

    // band 0: score 0 at the start cell (kmer -1, offset 50);
    // band 1 (a down move): first-event trim at offset 50
    Chain ch;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        ch.sp2[j] = (o0 + j == HALF) ? 0.0f : NEG;
        ch.sp[j] = (o0 + j == HALF) ? lp_trim : NEG;
    }
    trb[lane] = 0;
    trb[ROW_BYTES + lane] = (o0 <= HALF && HALF < o0 + 4)
        ? (uint8_t)(FROM_U << (2 * (HALF - o0))) : 0;
    if (lane == 0) { mvb[0] = 0; mvb[1] = 0; }

    ch.ll_e = HALF;
    ch.ll_k = -1 - HALF;
    ch.r_prev = 0;
    ch.best_s = NEG;
    ch.best_e = 0;

    for (int c = 0; c < n_chunks; ++c) {
        const int buf = c & 1;
        npt_bar_sync(BAR_FULL + buf, THREADS);
        const int kb = kbase[buf];
        const int b0 = 2 + c * LOOKAHEAD;
        const int b1 = min(b0 + LOOKAHEAD, n_bands);
        for (int bi = b0; bi < b1; ++bi) {
            // a band whose every placement lies inside the read, clear of
            // the trim column and of the last kmer, needs no edge rules
            const float* slot = ring[buf][bi - b0];
            if (ch.ll_e >= BW - 1 && ch.ll_e + 1 < nev && ch.ll_k >= 0 &&
                    ch.ll_k + BW + 1 < nk)
                band<false>(ch, slot, kb, bi, lane, nev, nk, nev_f, lps, lpt,
                            lp_skip, lp_trim, trb, mvb);
            else
                band<true>(ch, slot, kb, bi, lane, nev, nk, nev_f, lps, lpt,
                           lp_skip, lp_trim, trb, mvb);
        }
        if (c + 2 < n_chunks) {                  // chunk c + 2 starts here
            if (lane == 0) kbase[buf] = ch.ll_k;
            npt_bar_arrive(BAR_EMPTY + buf, THREADS);
        }
    }
    if (lane == 0) {
        lle_out[b] = ch.ll_e;
        beste_out[b] = ch.best_e;
        bests_out[b] = ch.best_s;
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
        banded_fill_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
            ev, T, mu, sig, cc, K, nev, nk, lps, lpt, lp_skip, lp_trim, B,
            n_bands, trace, moves, lle, best_e, best_s);
    return (int)cudaGetLastError();
}
