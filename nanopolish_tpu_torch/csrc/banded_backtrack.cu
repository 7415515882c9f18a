// Adaptive banded event alignment, backtrack (kernel 2 of the banded aligner).
//
// Replaces: nanopolish_tpu/ops/pallas_banded_exact.py _backtrack_kernel
// (:441) and the base->event scatter _b2e_from_pairs (:739).
// Spec: raw_loader.cpp:302-362 (walk) and squiggle_read.cpp:284-299
// (distinct-event base->event rule); plain version:
// nanopolish_tpu_torch/ops/banded_align.py banded_backtrack_plain, which
// this kernel matches bit for bit.
//
// What bounds it on the H100: the walk is one serial chain per read whose
// next cell depends on the move just read, so it is bound by the latency of
// one step, not by the ~33 B per band it reads.  The design keeps the chain
// short and moves everything else off it:
//   * one warp per read, WARPS reads per block; all 32 lanes walk the same
//     path (each step a broadcast shared-memory load), so no lane waits on
//     another for the state;
//   * the walk visits only the bands it steps on: from band bi a D move
//     goes to bi - 2, U and L to bi - 1.  It carries off = ll_e(bi) - ei,
//     the cell's offset in its band, and no event or kmer: each staged band
//     has a word of four bytes, the change of the offset for each move
//     (from the band's and the next band's placement bits), so a step is
//     the trace byte's load, the 2-bit decode, a byte permute of the word
//     (loaded beside it) and one add; UNROLL steps run between two exit
//     tests, the steps past an exit reading rows or bytes that are then
//     dropped;
//   * bands go in chunks of CH from the first band the walk visits (ll_e
//     there is lle_last less a warp sum over the bands above it), staged
//     one ahead into two buffers: 16-byte cp.async of the trace rows, and
//     the placement bytes loaded into registers and turned into words after
//     the walk of the chunk before;
//   * a chunk's walk cannot reach the read's first event or kmer, nor
//     leave the band, when its entry event and kmer are CH or more and its
//     offset lies CH or more inside the band (a visit moves each by at most
//     one): those chunks, nearly all, skip the end tests and the offset
//     clamp; the others are walked with both;
//   * lane j keeps the move out of visit j of the chunk: the chunk's path.
//     After the walk the lanes rebuild each visit's event, kmer and row
//     from ballots of the moves, and compute the emissions in parallel
//     from a 32-entry window of events and kmer parameters (4-byte
//     cp.async, issued when the walk enters the chunk: a chunk's visits
//     lie within 32 events and 32 kmers of its first), the summed emission
//     in walk order (the emissions through shared memory, every lane
//     adding them up one after another), the longest kmer-skip run (a
//     ballot, carried across chunks), the first and last visits' events,
//     and the base->event map:
//     b2e_stop[k] is k's first map-valid visit in walk order and
//     b2e_start[k] its last (the walk visits each kmer's events
//     contiguously and in decreasing order); within a chunk only the first
//     and the last such lane of a kmer write, and the last map-valid kmer
//     carries to the next chunk.
// Bits: each visit's emission is the same npt_log_normal on the same four
// floats as the plain version's, and the f32 sum adds them one after
// another in walk order, as it does.

#include "npt_common.cuh"

namespace {

constexpr int ROW_BYTES = 32;
constexpr int CH = 32;          // bands a chunk, one per lane when staged
constexpr int UNROLL = 4;       // walk steps between two exit tests
constexpr int PAD_ROWS = 2 * UNROLL;  // rows the steps past an exit may read
constexpr int WARPS = 4;        // reads a block, one warp each
constexpr int LANES = 128;
constexpr int FROM_D = 0, FROM_U = 1, FROM_L = 2;
constexpr int INT32_MAX_ = 2147483647;
constexpr unsigned NO_MOVE = 0x01010101u;   // offset change 0 (plus one)

// mw before pk and the windows after it: a step past the exit of a
// chunk walked without the offset clamp reads at most one byte outside
// pk's rows, and that byte is still in this struct
struct Stage {
    unsigned mw[2][CH + PAD_ROWS];              // a band's four offset changes
    uint8_t pk[2][CH + PAD_ROWS][ROW_BYTES];    // row i: band hi - i
    float ev[CH], mu[CH], sg[CH], cc[CH];       // entry j: event ei0 - j, kmer ki0 - j
    float lp[CH];                               // visit j's emission
};

// the placement bytes of band hi - lane and the band below it
__device__ __forceinline__ void load_moves(const uint8_t* mvb, int hi,
                                           int nrows, int lane, int& m0,
                                           int& m1) {
    m0 = 0;
    m1 = 1;
    if (lane < nrows) {
        m0 = mvb[hi - lane];
        if (hi - lane >= 1) m1 = mvb[hi - lane - 1];
    }
}

// copy the packed trace rows of bands hi, hi - 1, ..., hi - nrows + 1
// into pk (one group, empty when nrows <= 0)
__device__ __forceinline__ void stage_rows(uint8_t (*pk)[ROW_BYTES],
                                           const uint8_t* trb, int hi,
                                           int nrows, int lane) {
    if (lane < nrows) {
        const uint8_t* src = trb + (size_t)(hi - lane) * ROW_BYTES;
        npt_cp_async16(pk[lane], src);
        npt_cp_async16(pk[lane] + 16, src + 16);
    }
    npt_cp_async_commit();
}

// byte c: how the walk's offset off = ll_e(bi) - ei changes, plus one,
// when it leaves band bi by move c.  d(x) = 1 - move[x] is how far ll_e
// falls from band x to x - 1 (m0, m1: the placement bytes of bi and
// bi - 1), so D goes to off + 1 - d(bi) - d(bi - 1), U to
// off + 1 - d(bi), L to off - d(bi); byte 3 (no move) keeps it
__device__ __forceinline__ unsigned move_word(int m0, int m1) {
    const unsigned d0 = 1 - m0, d1 = 1 - m1;
    return (2 - d0 - d1) | (2 - d0) << 8 | (1 - d0) << 16 | 1u << 24;
}

// the move out of the cell at offset o of row rb
__device__ __forceinline__ int cell_move(const uint8_t* pk, int rb, int o) {
    return (pk[rb * ROW_BYTES + (o >> 2)] >> ((o & 3) << 1)) & 3;
}

// walk one chunk from row rb, offset off (the chain); lane j keeps the
// move out of visit j.  ENDS: test for the read's first event and kmer
// (with ei, ki) and clamp the offset; else the caller has checked that
// the chunk can reach neither and that the offset stays in the band.
// Returns the visits made.
template <bool ENDS>
__device__ __forceinline__ int walk_chunk(const uint8_t* pk,
                                          const unsigned* mw, int rb,
                                          int off, int end, int ei, int ki,
                                          int lane, int& my_mv) {
    int nv = 0;
    bool alive = rb < end;
    while (alive) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int mv = cell_move(
                pk, rb, ENDS ? __vimin_s32_relu(off, LANES - 1) : off);
            if (alive && lane == nv) my_mv = mv;
            nv += alive;
            bool stop = mv == 3;
            if (ENDS) {
                stop = stop || ki < (mv != FROM_U) || ei < (mv != FROM_L);
                ei -= mv < 2;
                ki -= !(mv & 1);
            }
            off += (int)__byte_perm(mw[rb], 0, mv | 0x4440) - 1;
            rb += 1 + (mv == FROM_D);
            alive = alive && !stop && rb < end;
        }
    }
    return nv;
}

__global__ void __launch_bounds__(WARPS * 32) banded_backtrack_kernel(
        const uint8_t* __restrict__ trace, const uint8_t* __restrict__ moves,
        const int* __restrict__ lle_last, const int* __restrict__ best_e_a,
        const float* __restrict__ ev, int T,
        const float* __restrict__ mu, const float* __restrict__ sig,
        const float* __restrict__ cc, int K, const int* __restrict__ nk_a,
        int B, int n_bands, int* __restrict__ b2e_start,
        int* __restrict__ b2e_stop, float* __restrict__ sum_em_out,
        int* __restrict__ stats_out) {
    __shared__ __align__(16) Stage stages[WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + warp;
    if (b >= B) return;
    Stage& st = stages[warp];
    const uint8_t* trb = trace + (size_t)b * n_bands * ROW_BYTES;
    const uint8_t* mvb = moves + (size_t)b * n_bands;
    const float* evb = ev + (size_t)b * T;
    const float* mub = mu + (size_t)b * K;
    const float* sgb = sig + (size_t)b * K;
    const float* ccb = cc + (size_t)b * K;
    int* sb = b2e_start + (size_t)b * K;
    int* tb = b2e_stop + (size_t)b * K;
    for (int k = lane; k < K; k += 32) { sb[k] = -1; tb[k] = -1; }
    for (int i = lane; i < 2 * (CH + PAD_ROWS); i += 32) (&st.mw[0][0])[i] = NO_MOVE;
    __syncwarp();                       // before any lane's map writes

    int ki = nk_a[b] - 1, ei = best_e_a[b];
    const int bi0 = ei + ki + 2;        // the first (highest) band visited
    float sum_em = 0.0f;
    int n_pairs = 0, cur_gap = 0, max_gap = 0;
    int min_ev = INT32_MAX_, max_ev = -1, last_ki = -1, last_map_k = -1;
    if (bi0 >= 0 && bi0 < n_bands) {
        int down = 0;
        for (int j = bi0 + 1 + lane; j < n_bands; j += 32) down += 1 - mvb[j];
        int off = lle_last[b] - __reduce_add_sync(NPT_FULL_MASK, down) - ei;
        int hi = bi0, nrows = min(CH, bi0 + 1), rb = 0, q = 0;
        int m0, m1;
        load_moves(mvb, hi, nrows, lane, m0, m1);
        stage_rows(st.pk[0], trb, hi, nrows, lane);
        if (lane < nrows) st.mw[0][lane] = move_word(m0, m1);
        npt_cp_async_wait_all();
        __syncwarp();
        for (;;) {
            // the chunk's emission window, for after its walk
            const int ei0 = ei, ki0 = ki;
            const int ke = npt_clampi(ki0 - lane, 0, K - 1);
            npt_cp_async4(&st.ev[lane], evb + npt_clampi(ei0 - lane, 0, T - 1));
            npt_cp_async4(&st.mu[lane], mub + ke);
            npt_cp_async4(&st.sg[lane], sgb + ke);
            npt_cp_async4(&st.cc[lane], ccb + ke);
            npt_cp_async_commit();
            // the next chunk's rows into the other buffer
            const int hi_n = hi - nrows, nrows_n = min(CH, hi_n + 1);
            load_moves(mvb, hi_n, nrows_n, lane, m0, m1);
            stage_rows(st.pk[q ^ 1], trb, hi_n, nrows_n, lane);

            // the walk: within CH visits of its entry the offset moves by
            // at most CH and the event and kmer fall by at most CH
            const int end = nrows;
            const uint8_t* pk = &st.pk[q][0][0];
            const unsigned* mw = st.mw[q];
            int my_mv = 3;
            const bool far = ei0 >= CH && ki0 >= CH && off >= CH &&
                             off < LANES - CH;
            const int nv = far
                ? walk_chunk<false>(pk, mw, rb, off, end, ei, ki, lane, my_mv)
                : walk_chunk<true>(pk, mw, rb, off, end, ei, ki, lane, my_mv);

            // off the chain: the chunk's nv visits, lane j holding visit
            // j's move; each visit's event, kmer and row from ballots
            const bool valid = lane < nv;
            const int mv = valid ? my_mv : 3;
            const unsigned lt = (1u << lane) - 1u;
            const unsigned dm = __ballot_sync(NPT_FULL_MASK, mv == FROM_D);
            const unsigned um = __ballot_sync(NPT_FULL_MASK, mv == FROM_U);
            const unsigned lm = __ballot_sync(NPT_FULL_MASK, mv == FROM_L);
            const int my_e = ei0 - __popc((dm | um) & lt);
            const int my_k = ki0 - __popc((dm | lm) & lt);
            const int my_r = rb + lane + __popc(dm & lt);
            off += __reduce_add_sync(NPT_FULL_MASK, valid
                ? (int)__byte_perm(mw[min(my_r, end - 1)], 0, mv | 0x4440) - 1 : 0);
            ei = ei0 - __popc(dm | um);
            ki = ki0 - __popc(dm | lm);
            rb += nv + __popc(dm) - end;
            const bool term = my_k < (mv != FROM_U) || my_e < (mv != FROM_L);
            const bool stopped = __ballot_sync(NPT_FULL_MASK,
                                               lane == nv - 1 && (term || mv == 3));
            const bool done = stopped || hi_n < 0;
            npt_cp_async_wait_all();    // the window and the next rows
            __syncwarp();

            // the emission's operands first: their loads overlap the rest
            const int je = min(ei0 - my_e, CH - 1), jk = min(ki0 - my_k, CH - 1);
            const float x = st.ev[je], m = st.mu[jk], sg = st.sg[jk], c = st.cc[jk];
            const bool is_l = mv == FROM_L;
            // the run of kmer skips ending at each visit
            const unsigned upto = __ballot_sync(NPT_FULL_MASK, valid && !is_l) &
                                  ((2u << lane) - 1u);
            const int gap = upto ? lane - (31 - __clz(upto)) : cur_gap + lane + 1;
            max_gap = max(max_gap, __reduce_max_sync(NPT_FULL_MASK, valid ? gap : 0));
            // base->event map: a visit enters it unless it is a kmer skip,
            // and the walk's last visit always does
            const bool ok = valid && (!is_l || (term && lane == nv - 1));
            const unsigned okm = __ballot_sync(NPT_FULL_MASK, ok);
            const int kc = npt_clampi(my_k, 0, K - 1);
            const unsigned below = okm & lt;
            const unsigned above = okm & ~((2u << lane) - 1u);
            const int k_prev = __shfl_sync(NPT_FULL_MASK, kc,
                                           below ? 31 - __clz(below) : lane);
            const int k_next = __shfl_sync(NPT_FULL_MASK, kc,
                                           above ? __ffs(above) - 1 : lane);
            if (ok) {
                if (kc != (below ? k_prev : last_map_k)) tb[kc] = my_e;
                if (!above || k_next != kc) sb[kc] = my_e;
            }
            if (okm) last_map_k = __shfl_sync(NPT_FULL_MASK, kc, 31 - __clz(okm));
            if (nv > 0) {
                n_pairs += nv;
                cur_gap = __shfl_sync(NPT_FULL_MASK, gap, nv - 1);
                last_ki = __shfl_sync(NPT_FULL_MASK, my_k, nv - 1);
                min_ev = min(min_ev, __shfl_sync(NPT_FULL_MASK, my_e, nv - 1));
                max_ev = max(max_ev, ei0);
            }
            // the summed emission, one add after another in walk order
            st.lp[lane] = npt_log_normal(x, m, sg, c);
            __syncwarp();
            float4 v[CH / 4];
#pragma unroll
            for (int i = 0; i < CH / 4; ++i)
                v[i] = reinterpret_cast<const float4*>(st.lp)[i];
#pragma unroll
            for (int i = 0; i < CH / 4; ++i) {
                if (4 * i >= nv) break;
                sum_em = npt_add(sum_em, v[i].x);
                if (4 * i + 1 < nv) sum_em = npt_add(sum_em, v[i].y);
                if (4 * i + 2 < nv) sum_em = npt_add(sum_em, v[i].z);
                if (4 * i + 3 < nv) sum_em = npt_add(sum_em, v[i].w);
            }
            if (done) break;
            if (lane < nrows_n) st.mw[q ^ 1][lane] = move_word(m0, m1);
            __syncwarp();               // every lane is past this chunk
            hi = hi_n;
            nrows = nrows_n;
            q ^= 1;
        }
        npt_cp_async_wait_all();        // no copy outlives the block
    }
    if (lane == 0) {
        sum_em_out[b] = sum_em;
        int* s = stats_out + (size_t)b * 5;
        s[0] = n_pairs;
        s[1] = max_gap;
        s[2] = last_ki;
        s[3] = min_ev;
        s[4] = max_ev;
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
        banded_backtrack_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                                  (cudaStream_t)stream>>>(
            trace, moves, lle, best_e, ev, T, mu, sig, cc, K, nk, B, n_bands,
            b2e_start, b2e_stop, sum_em, stats);
    return (int)cudaGetLastError();
}
