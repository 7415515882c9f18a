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
// time of one band step on one warp.
//
// The design keeps only the score recurrence on that warp.  Band bi is the
// anti-diagonal e + k = bi - 2, so a cell's emission depends only on
// (bi, k), and the band's placement decides only which k range it covers.
// Each block (one read) has eight warps in four roles:
//   * the chain warp (warp 0) runs the recurrence: four contiguous offsets
//     a lane (lanes 25-31 hold offsets 100-127, always -inf), the last two
//     bands in registers, the Suzuki placement from two broadcasts of the
//     band edges, the neighbour offsets by two shuffles.  Per band it
//     writes its cells, its up-move candidates (su) and its ll_k to a ring
//     in shared memory.  A chunk whose every band lies inside the read,
//     clear of the trim column and of the last kmer (nearly every chunk of
//     a long read; tested once, at the chunk's start) runs the steady
//     loop: offset j under placement r reads its emission, up, left and
//     diagonal cells at m = j + r alone, so the five candidates of m = 0..4
//     are computed before the placement is known, which then selects four
//     of them; the diagonal terms (cell + lpt) come shifted by the band
//     before's placement; lanes 0 and 25 take their previous neighbour
//     from lane 31, so the -inf of lanes 25-31 keeps the band's edges with
//     no mask; the loop takes bands in pairs, so the two bands' registers
//     swap roles without moves.  Other chunks run the general band (every
//     rule applied by selects);
//   * PRODUCERS producer warps (1-3) fill a ring of emissions: two chunks
//     of LOOKAHEAD bands, each band a slot of SPAN emissions over kmers
//     kb + t (t < SPAN), kb the chain's ll_k at the end of the chunk
//     before the previous one.  ll_k only grows, by at most one a band, so
//     the 100 offsets of every placement a chunk's bands can take lie in
//     kb .. kb + 2 LOOKAHEAD + 99 < kb + SPAN.  A chunk's kmers are the
//     same for its every band: a producer loads them once a chunk, then
//     the events along its bands' anti-diagonals, and evaluates
//     npt_log_normal there, with its division;
//   * CONSUMERS consumer warps (5-7) take the chain's bands from its ring
//     of CELL_BUFS chunks, each a run of PER_CONSUMER consecutive bands of
//     a chunk (the run's first band also reads the band before it, the
//     last of the chunk before for the first run): they recompute the
//     left-move candidates from the previous band's cells, derive the
//     2-bit moves (cell == sl -> FROM_L, else cell == su -> FROM_U, which
//     is the plain version's m3 == sl, m2 == su: where m3 != sl, m3 is
//     m2), apply the edge rules where the band is not inside the read,
//     store the 32-byte trace row and the placement bytes, and track the
//     trailing-trim best of their runs, merged at the end;
//   * warp 4 leaves after the set-up.  On the H100, warp w shares its SM
//     sub-partition with warp w + 4 (an issue-bound pair of warps runs
//     1.56x slower together than any other pair), so no other busy warp
//     shares the chain's.
// The roles meet on named barriers once per chunk: FULL (the producers
// filled a chunk), EMPTY (the chain is done with one and has written the
// kb that the chunk after next uses), CFULL (the chain wrote a chunk of
// cells) and CEMPTY (the consumers are done with one).  tests/banded_ring.py
// models this schedule.
//
// A read's bands from D = n_events + n_kmers + 2 on lie past its last
// cell: every cell is -inf, no cell is valid, each placement is bi & 1
// (both edges -inf).  The chain stops at D, so a block takes its own
// read's time, not the launch's longest; the producers write those bands'
// zero rows and placement bytes after their ring work, and the chain adds
// their down moves to ll_e.
//
// What is left (H100, 700 W; PERF.md): the steady loop is 136 SASS
// instructions a pair of bands, 68 a band (the band before this design:
// ~171), and runs ~143 cycles a band; the chain waits besides ~30 cycles a
// band on the consumers, whose sub-partitions the producers share (each
// IEEE division carries its own slow-path branch, so a producer's
// divisions run one after another).  ~92 ns a chain band on the
// benchmark's longest launch (64 reads, the longest 79.5 kb), against ~275
// before.  Timed on the card against this design: branching on the
// placement (4 bodies, or 2 with the placement decided a band ahead), a
// bank-conflict-free emission layout (its addressing costs the chain more
// than the conflicts), and 12 warps (4 producers, 5 consumers: 4% faster
// on the long launch, 15% slower on 256 reads a launch, where two blocks
// share an SM).
//
// Bits: every emission is the same npt_log_normal on the same four floats
// (indices clamped as before; a clamped cell is never valid), only on
// another warp; the chain adds in the order of banded_fill_plain.  Its
// steady loop takes maxima with fmaxf, which differs from the plain
// version's a > b ? a : b only on NaN and on +0 against -0: no score is
// NaN (finite inputs, and no inf - inf: every infinity is -inf) and none
// is -0 (round-to-nearest sums give -0 only from two -0s; the start score
// is +0).  The consumers recompute sl with the chain's one add and keep the
// strict > for best_s and the trailing trim's one __fmaf_rn.

#include "npt_common.cuh"

namespace {

constexpr int BW = 100;     // band width (ALN_BANDWIDTH)
constexpr int HALF = 50;
constexpr int ROW_BYTES = 32;
constexpr int FROM_U = 1;
constexpr int FROM_L = 2;
constexpr int LANES_IN = 25;                 // chain lanes holding offsets < BW
constexpr int LOOKAHEAD = 14;                // bands per chunk
constexpr int SPAN = 128;                    // BW + 2 LOOKAHEAD kmers a slot
constexpr int EM_BUFS = 2;                   // emission ring, in chunks
constexpr int CELL_BUFS = 3;                 // cell ring, in chunks
constexpr int WARPS = 8;
constexpr int CHAIN_WARP = 0;                // warp 4 idles
constexpr int PRODUCERS = 3;                 // warps 1-3
constexpr int CONSUMERS = 3;                 // warps 5-7
constexpr int THREADS = 32 * WARPS;
constexpr int BAR_FULL = 1;                  // + emission buffer
constexpr int BAR_EMPTY = 3;                 // + emission buffer
constexpr int BAR_CFULL = 5;                 // + cell buffer
constexpr int BAR_CEMPTY = 8;                // + cell buffer
constexpr int BAR_DONE = 11;                 // the consumers' best
constexpr int PRODUCER_THREADS = 32 * (1 + PRODUCERS);
constexpr int PER_CONSUMER = (LOOKAHEAD + CONSUMERS - 1) / CONSUMERS;
constexpr int CONSUMER_THREADS = 32 * (1 + CONSUMERS);
static_assert(SPAN == BW + 2 * LOOKAHEAD, "a slot covers two chunks' drift");
static_assert(SPAN % 32 == 0, "a producer lane fills SPAN / 32 kmers");
static_assert(LANES_IN * 4 == BW, "25 lanes of four offsets");
static_assert(LOOKAHEAD % 2 == 0, "the steady loop takes bands in pairs");
static_assert(CHAIN_WARP == 0 && WARPS % 4 == 0 &&
              PRODUCERS + CONSUMERS == WARPS - WARPS / 4,
              "warp roles: the warps 4k other than the chain idle");

// one band of the chain as the consumers read it: its cells at offsets
// 0-99, and su at 0-103, where su[o + r] is offset o's up-move candidate
// under placement r (su[100 + i] is -inf)
struct alignas(16) BandRec {
    float cell[BW];
    float su[BW + 4];
};

__device__ void produce(float (*ring)[LOOKAHEAD][SPAN], const int* kbase,
                        const float* __restrict__ evb, int T,
                        const float* __restrict__ mub,
                        const float* __restrict__ sgb,
                        const float* __restrict__ ccb, int K, int D,
                        int n_chunks, int pw, int lane) {
    constexpr int PER = (LOOKAHEAD + PRODUCERS - 1) / PRODUCERS;
    for (int c = 0; c < n_chunks; ++c) {
        const int buf = c & 1;
        if (c >= 2) npt_bar_sync(BAR_EMPTY + buf, PRODUCER_THREADS);
        const int kb = kbase[buf];
        const int b0 = 2 + c * LOOKAHEAD;
        const int nb = min(LOOKAHEAD, D - b0);
        // the chunk's kmers, the same for its every band
        float mu[SPAN / 32], sg[SPAN / 32], cc[SPAN / 32];
#pragma unroll
        for (int i = 0; i < SPAN / 32; ++i) {
            const int k = npt_clampi(kb + lane + 32 * i, 0, K - 1);
            mu[i] = __ldg(mub + k);
            sg[i] = __ldg(sgb + k);
            cc[i] = __ldg(ccb + k);
        }
        // band s, slot t = lane + 32 i: event b0 + s - 2 - kb - t
        const int e0 = b0 - 2 - kb - lane;
        float ev[PER][SPAN / 32];
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            const int s = pw + q * PRODUCERS;
#pragma unroll
            for (int i = 0; i < SPAN / 32; ++i)
                ev[q][i] = s < nb
                    ? __ldg(evb + npt_clampi(e0 + s - 32 * i, 0, T - 1)) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            const int s = pw + q * PRODUCERS;
            if (s < nb) {
#pragma unroll
                for (int i = 0; i < SPAN / 32; ++i)
                    ring[buf][s][lane + 32 * i] =
                        npt_log_normal(ev[q][i], mu[i], sg[i], cc[i]);
            }
        }
        npt_bar_arrive(BAR_FULL + buf, PRODUCER_THREADS);
    }
}

// the chain's state: the last two bands' scores (four offsets a lane),
// the last band's lower-left cell and placement
struct Chain {
    float sp[4], sp2[4];
    int ll_e, ll_k, r_prev;
};

// the band's ring entry: cells of lanes 0-24, su of lanes 0-25, ll_k
__device__ __forceinline__ void put(BandRec* rc, int* rw, int lane,
                                    const float (&cell)[4],
                                    const float (&su)[4], int ll_k) {
    if (lane < LANES_IN)
        *reinterpret_cast<float4*>(rc->cell + 4 * lane) =
            make_float4(cell[0], cell[1], cell[2], cell[3]);
    if (lane <= LANES_IN)
        *reinterpret_cast<float4*>(rc->su + 4 * lane) =
            make_float4(su[0], su[1], su[2], su[3]);
    if (lane == 0) *rw = ll_k;
}

// one band of the general chain.  EDGE applies the rules of the read's
// edges: cells outside the read, the trim column (kmer -1); without it
// every offset below 100 is a valid cell, which holds when the caller has
// checked that both placements keep the band inside the read and clear of
// the trim column.  Either way every cell is evaluated and the rules
// select its value: no branch, so the four offsets' chains interleave.
template <bool EDGE>
__device__ __forceinline__ void band(
        Chain& ch, const float* slot, int kb, int bi, int lane, int nev,
        int nk, float lps, float lpt, float lp_skip, float lp_trim,
        BandRec* rc, int* rw) {
    const float NEG = npt_neg_inf();
    const int o0 = 4 * lane;
    const bool lane_in = lane < LANES_IN;       // offsets o0 .. o0 + 3 < 100
    // emissions for both placements: down puts kmer ll_k + o at offset o
    // (slot j), right puts ll_k + 1 + o there (slot j + 1); lanes past
    // offset 100 read slot 0, which they never use
    const int t0 = lane_in ? ch.ll_k - kb + o0 : 0;
    float emw[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) emw[j] = slot[t0 + j];

    // adaptive placement (raw_loader.cpp:175-195)
    const float ll = __shfl_sync(NPT_FULL_MASK, ch.sp[0], 0);
    const float ur = __shfl_sync(NPT_FULL_MASK, ch.sp[3], LANES_IN - 1);
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

    float cell[4], su[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        // the ring's su: offset o0 + j - r's candidate under placement r
        su[j] = npt_add(npt_add(ch.sp[j], lps), emw[j]);
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
        const float s_u = npt_add(npt_add(up, lps), em);
        const float sl = npt_add(left, lp_skip);
        const float m3 = npt_max(npt_max(sd, s_u), sl);
        if (EDGE) {
            // trim column (raw_loader.cpp:215-225)
            const bool trim = in_e && ki == -1;
            const float tv = npt_mul(lp_trim, npt_add((float)ei, 1.0f));
            cell[j] = valid ? m3 : (trim ? tv : NEG);
        } else {
            cell[j] = valid ? m3 : NEG;
        }
    }
    put(rc, rw, lane, cell, su, ch.ll_k);
#pragma unroll
    for (int j = 0; j < 4; ++j) { ch.sp2[j] = ch.sp[j]; ch.sp[j] = cell[j]; }
    ch.r_prev = r;
}

// one band of a steady chunk.  Offset o = 4 lane + j under placement r
// reads the emission, up, left and diagonal cells at m = j + r alone
// (em[m], E[m + 1], E[m], dg[m]; E the previous band at offsets 4 lane - 1
// .. 4 lane + 4), so the five candidates M[m] are computed before the
// placement, which then picks four of them.  dg[m] is the diagonal term
// (cell + lpt) at m, made by the band before from its own E and placement.
// The cells go into out (the caller swaps the two arrays' roles every
// band); em is refilled with the next band's emissions when more is set.
template <bool ODD>
__device__ __forceinline__ void steady_band(
        const float (&sp)[4], float (&out)[4], float (&dg)[5], int& ll_k,
        float (&em)[5], const float* next_em, bool more, BandRec* rc,
        int* rw, int lane, int src_next, int src_prev, float lps, float lpt,
        float lp_skip) {
    const float NEG = npt_neg_inf();
    const float ll = __shfl_sync(NPT_FULL_MASK, sp[0], 0);
    const float ur = __shfl_sync(NPT_FULL_MASK, sp[3], LANES_IN - 1);
    const float nx = __shfl_sync(NPT_FULL_MASK, sp[0], src_next);
    const float pv = __shfl_sync(NPT_FULL_MASK, sp[3], src_prev);
    const float E[6] = {pv, sp[0], sp[1], sp[2], sp[3], nx};
    float M[5], su[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
        const float sd = npt_add(dg[m], em[m]);
        su[m] = npt_add(npt_add(E[m + 1], lps), em[m]);
        const float sl = npt_add(E[m], lp_skip);
        M[m] = fmaxf(fmaxf(sd, su[m]), sl);
    }
    // both edges -inf: bi & 1, which is 0 on an even band, as ll < ur is
    const bool right = ODD ? (ll < ur || (ll == NEG && ur == NEG)) : ll < ur;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = right ? M[j + 1] : M[j];
#pragma unroll
    for (int m = 0; m < 5; ++m) dg[m] = npt_add(right ? E[m + 1] : E[m], lpt);
    ll_k += right;
    if (more) {
#pragma unroll
        for (int j = 0; j < 5; ++j) em[j] = next_em[ll_k + j];
    }
    const float su4[4] = {su[0], su[1], su[2], su[3]};
    put(rc, rw, lane, out, su4, ll_k);
}

__device__ void consume(const BandRec (*rec)[LOOKAHEAD],
                        const int (*recw)[LOOKAHEAD], float* best_s_sh,
                        int* best_e_sh, uint8_t* trb, uint8_t* mvb, int nev,
                        int nk, float lp_skip, float lp_trim, int n_chunks,
                        int D, int cw, int lane, float* best_s_out,
                        int* best_e_out) {
    const float NEG = npt_neg_inf();
    const float nev_f = (float)nev;
    const int o0 = 4 * lane;
    const int li = min(lane, LANES_IN - 1);
    const int lu = min(lane, LANES_IN);
    if (cw == 0) {
        // band 0: score 0 at the start cell; band 1 (a down move): the
        // first-event trim at offset 50
        trb[lane] = 0;
        trb[ROW_BYTES + lane] = (o0 <= HALF && HALF < o0 + 4)
            ? (uint8_t)(FROM_U << (2 * (HALF - o0))) : 0;
        if (lane == 0) { mvb[0] = 0; mvb[1] = 0; }
    }
    float best_s = NEG;
    int best_e = 0;
    for (int c = 0; c < n_chunks; ++c) {
        const int cb = c % CELL_BUFS;
        const int pb = (c + CELL_BUFS - 1) % CELL_BUFS;
        npt_bar_sync(BAR_CFULL + cb, CONSUMER_THREADS);
        const int b0 = 2 + c * LOOKAHEAD;
        const int nb = min(LOOKAHEAD, D - b0);
        // this consumer's run of the chunk's bands, every load first so
        // that their latencies overlap; each band's previous cells are the
        // band before's, and the neighbour values come by shuffle
        const int s0 = cw * PER_CONSUMER;
        const int n_run = min(PER_CONSUMER, nb - s0);
        int k1[PER_CONSUMER], rr = 0;
        float4 c4[PER_CONSUMER], u4[PER_CONSUMER];
        float4 q4 = *reinterpret_cast<const float4*>(
            (s0 > 0 ? rec[cb][s0 - 1] : rec[pb][LOOKAHEAD - 1]).cell + 4 * li);
        int k0 = s0 > 0 ? recw[cb][s0 - 1] : recw[pb][LOOKAHEAD - 1];
#pragma unroll
        for (int i = 0; i < PER_CONSUMER; ++i) {
            if (i < n_run) {
                const BandRec& cur = rec[cb][s0 + i];
                k1[i] = recw[cb][s0 + i];
                c4[i] = *reinterpret_cast<const float4*>(cur.cell + 4 * li);
                // su[o + r]: the lane's four, and lane 25's -inf beyond
                u4[i] = *reinterpret_cast<const float4*>(cur.su + 4 * lu);
            }
        }
#pragma unroll
        for (int i = 0; i < PER_CONSUMER; ++i) {
            if (i >= n_run) break;
            const int bi = b0 + s0 + i;
            const int r = k1[i] - k0;
            const int ll_e = bi - 2 - k1[i];
            const float cl[4] = {c4[i].x, c4[i].y, c4[i].z, c4[i].w};
            const float u5 = __shfl_down_sync(NPT_FULL_MASK, u4[i].x, 1);
            const float su5[5] = {u4[i].x, u4[i].y, u4[i].z, u4[i].w, u5};
            const float q[4] = {q4.x, q4.y, q4.z, q4.w};
            const float pu = __shfl_up_sync(NPT_FULL_MASK, q4.w, 1);
            const float pv = lane > 0 ? pu : NEG;
            // every offset below 100 a cell of the read, none in the trim
            // column: no edge rules
            const bool inside = ll_e >= BW - 1 && ll_e < nev && k1[i] >= 0 &&
                                k1[i] + BW <= nk;
            uint32_t packed = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float left = r ? q[j] : (j > 0 ? q[j - 1] : pv);
                const float sl = npt_add(left, lp_skip);
                const float su = r ? su5[j + 1] : su5[j];
                const uint32_t code = cl[j] == sl ? FROM_L : (cl[j] == su ? FROM_U : 0);
                packed |= code << (2 * j);
            }
            if (!inside) {
                uint32_t edge = 0;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int o = o0 + j;
                    const int ei = ll_e - o, ki = k1[i] + o;
                    const bool in_e = o < BW && (unsigned)ei < (unsigned)nev;
                    const bool valid = in_e && (unsigned)ki < (unsigned)nk;
                    const bool trim = in_e && ki == -1;
                    const uint32_t code = (packed >> (2 * j)) & 3;
                    edge |= (valid ? code : (trim ? FROM_U : 0)) << (2 * j);
                }
                packed = edge;
            }
            packed = lane < LANES_IN ? packed : 0;
            trb[(size_t)bi * ROW_BYTES + lane] = (uint8_t)packed;
            rr = lane == i ? r : rr;
            // trailing trim of the last kmer (raw_loader.cpp:313-324)
            const int o_end = nk - 1 - k1[i];
            const int ee = ll_e - o_end;
            if (nk > 0 && o_end >= 0 && o_end < BW && (unsigned)ee < (unsigned)nev) {
                const float v = __fmaf_rn(npt_sub(nev_f, (float)ee), lp_trim,
                                          rec[cb][s0 + i].cell[o_end]);
                // strict: the earliest event wins
                if (v > best_s) { best_s = v; best_e = ee; }
            }
            q4 = c4[i];
            k0 = k1[i];
        }
        // the run's placement bytes, one lane each
        if (lane < n_run) mvb[b0 + s0 + lane] = (uint8_t)rr;
        if (c + 2 < n_chunks)
            npt_bar_arrive(BAR_CEMPTY + cb, CONSUMER_THREADS);
    }
    // each consumer saw its runs in band order: the best is the largest,
    // the earliest event among equals (-inf everywhere: event 0)
    if (lane == 0) { best_s_sh[cw] = best_s; best_e_sh[cw] = best_e; }
    npt_bar_sync(BAR_DONE, 32 * CONSUMERS);
    if (cw == 0 && lane == 0) {
#pragma unroll
        for (int i = 1; i < CONSUMERS; ++i) {
            const float v = best_s_sh[i];
            const int e = best_e_sh[i];
            if (v > best_s || (v == best_s && e < best_e)) { best_s = v; best_e = e; }
        }
        *best_s_out = best_s;
        *best_e_out = best_e;
    }
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
    __shared__ float ring[EM_BUFS][LOOKAHEAD][SPAN];
    __shared__ BandRec rec[CELL_BUFS][LOOKAHEAD];
    __shared__ int recw[CELL_BUFS][LOOKAHEAD];
    __shared__ int kbase[EM_BUFS];
    __shared__ float best_s_sh[CONSUMERS];
    __shared__ int best_e_sh[CONSUMERS];
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (b >= B) return;
    const int nev = nev_a[b], nk = nk_a[b];
    // bands from D on lie past the read's last cell
    const int D = max(2, min(nev + nk + 2, n_bands));
    const int n_chunks = (D - 2 + LOOKAHEAD - 1) / LOOKAHEAD;
    uint8_t* trb = trace + (size_t)b * n_bands * ROW_BYTES;
    uint8_t* mvb = moves + (size_t)b * n_bands;
    if (threadIdx.x == 0) kbase[0] = kbase[1] = -1 - HALF;
    __syncthreads();
    if (warp != CHAIN_WARP && warp % 4 == 0) return;
    if (warp != CHAIN_WARP) {
        const int role = warp - 1 - warp / 4;   // 1-3 -> 0-2, 5-7 -> 3-5, ...
        if (role < PRODUCERS) {
            produce(ring, kbase, ev + (size_t)b * T, T, mu + (size_t)b * K,
                    sig + (size_t)b * K, cc + (size_t)b * K, K, D, n_chunks,
                    role, lane);
            // the bands past the read: zero rows, placement bi & 1
            const int tid = role * 32 + lane;
            uint4* tail = reinterpret_cast<uint4*>(trb + (size_t)D * ROW_BYTES);
            const int n16 = (n_bands - D) * (ROW_BYTES / 16);
            for (int i = tid; i < n16; i += 32 * PRODUCERS)
                tail[i] = make_uint4(0, 0, 0, 0);
            for (int bi = D + tid; bi < n_bands; bi += 32 * PRODUCERS)
                mvb[bi] = (uint8_t)(bi & 1);
        } else {
            consume(rec, recw, best_s_sh, best_e_sh, trb, mvb, nev, nk,
                    lp_skip, lp_trim, n_chunks, D, role - PRODUCERS, lane,
                    bests_out + b, beste_out + b);
        }
        return;
    }

    const float NEG = npt_neg_inf();
    const float lps = lps_a[b], lpt = lpt_a[b];
    const int o0 = 4 * lane;
    // the steady loop's neighbours: lanes 25-31 hold -inf, and lanes 0 and
    // 25 read lane 31 for their previous one, so their cells stay -inf
    const int src_next = lane == 31 ? 31 : lane + 1;
    const int src_prev = (lane == 0 || lane == LANES_IN) ? 31 : lane - 1;
    const int li = min(lane, LANES_IN - 1);

    // band 0: score 0 at the start cell (kmer -1, offset 50);
    // band 1 (a down move): first-event trim at offset 50
    Chain ch;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        ch.sp2[j] = (o0 + j == HALF) ? 0.0f : NEG;
        ch.sp[j] = (o0 + j == HALF) ? lp_trim : NEG;
    }
    ch.ll_e = HALF;
    ch.ll_k = -1 - HALF;
    ch.r_prev = 0;
    {   // band 1 as the band before chunk 0, for the consumers
        const float none[4] = {NEG, NEG, NEG, NEG};
        put(&rec[CELL_BUFS - 1][LOOKAHEAD - 1], &recw[CELL_BUFS - 1][LOOKAHEAD - 1],
            lane, ch.sp, none, ch.ll_k);
    }

    for (int c = 0; c < n_chunks; ++c) {
        const int buf = c & 1;
        const int cb = c % CELL_BUFS;
        npt_bar_sync(BAR_FULL + buf, PRODUCER_THREADS);
        if (c >= 2)
            npt_bar_sync(BAR_CEMPTY + (c - 2) % CELL_BUFS, CONSUMER_THREADS);
        const int kb = kbase[buf];
        const int b0 = 2 + c * LOOKAHEAD;
        const int nb = min(LOOKAHEAD, D - b0);
        // every band of the chunk steady: ll_e and ll_k grow by at most
        // one a band
        if (nb == LOOKAHEAD && ch.ll_e >= BW - 1 &&
                ch.ll_e + LOOKAHEAD < nev && ch.ll_k >= 0 &&
                ch.ll_k + LOOKAHEAD + BW < nk) {
            // this lane's five emissions of band s at ll_k: em_at(s)[ll_k + j]
            const float* em0 = &ring[buf][0][4 * li] - kb;
            // the first band's diagonal terms, from the band before the last
            const float nxt2 = __shfl_sync(NPT_FULL_MASK, ch.sp2[0], src_next);
            const float prv2 = __shfl_sync(NPT_FULL_MASK, ch.sp2[3], src_prev);
            const float E2[6] = {prv2, ch.sp2[0], ch.sp2[1], ch.sp2[2],
                                 ch.sp2[3], nxt2};
            float dg[5];
#pragma unroll
            for (int m = 0; m < 5; ++m)
                dg[m] = npt_add(ch.r_prev ? E2[m + 1] : E2[m], lpt);
            int ll_k = ch.ll_k, ll_k_mid = ll_k;
            float em[5];
#pragma unroll
            for (int j = 0; j < 5; ++j) em[j] = em0[ll_k + j];
            BandRec* rc = &rec[cb][0];
            int* rw = &recw[cb][0];
#pragma unroll 1
            for (int s = 0; s < LOOKAHEAD; s += 2) {
                steady_band<false>(ch.sp, ch.sp2, dg, ll_k, em,
                                   em0 + (s + 1) * SPAN, true, rc, rw, lane,
                                   src_next, src_prev, lps, lpt, lp_skip);
                ll_k_mid = ll_k;
                steady_band<true>(ch.sp2, ch.sp, dg, ll_k, em,
                                  em0 + (s + 2) * SPAN, s + 2 < LOOKAHEAD,
                                  rc + 1, rw + 1, lane, src_next, src_prev,
                                  lps, lpt, lp_skip);
                rc += 2;
                rw += 2;
            }
            // ch.sp holds the last band, ch.sp2 the one before
            ch.r_prev = ll_k - ll_k_mid;
            ch.ll_k = ll_k;
            ch.ll_e = b0 + LOOKAHEAD - 3 - ll_k;
        } else {
            for (int s = 0; s < nb; ++s) {
                const int bi = b0 + s;
                const float* slot = ring[buf][s];
                // a band whose every placement lies inside the read, clear
                // of the trim column and of the last kmer, needs no edge
                // rules
                if (ch.ll_e >= BW - 1 && ch.ll_e + 1 < nev && ch.ll_k >= 0 &&
                        ch.ll_k + BW + 1 < nk)
                    band<false>(ch, slot, kb, bi, lane, nev, nk, lps, lpt,
                                lp_skip, lp_trim, &rec[cb][s], &recw[cb][s]);
                else
                    band<true>(ch, slot, kb, bi, lane, nev, nk, lps, lpt,
                               lp_skip, lp_trim, &rec[cb][s], &recw[cb][s]);
            }
        }
        if (c + 2 < n_chunks) {                  // chunk c + 2 starts here
            if (lane == 0) kbase[buf] = ch.ll_k;
            npt_bar_arrive(BAR_EMPTY + buf, PRODUCER_THREADS);
        }
        npt_bar_arrive(BAR_CFULL + cb, CONSUMER_THREADS);
    }
    // bands D .. n_bands - 1 move down on their even bands
    if (lane == 0)
        lle_out[b] = ch.ll_e + ((n_bands - 1) >> 1) - ((D - 1) >> 1);
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
