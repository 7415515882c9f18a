// eventalign's segment chain, one round at a time: the per-round host work
// of the wavefront moved onto the card.
//
// Replaces: the loop body of nanopolish_tpu/alignment/device_chain.py
// _chain_program (:226-377), the XLA ops around the Viterbi kernels
// (_profile_hmm_viterbi_call) that the JAX chain runs in a while_loop.
// Spec: align_read_to_ref's loop (nanopolish_eventalign.cpp:689-823), as
// nanopolish_tpu_torch/alignment/eventalign.py _prepare and _consume run it
// on the host; plain version: nanopolish_tpu_torch/ops/chain_step.py
// chain_prepare_plain and chain_consume_plain, which these kernels match
// exactly (ops/chain_step.py documents the tensors).
//
// Two operations, one warp per job slot, WARPS slots per block; a call's
// jobs wait in a queue (their rows in queue order, the head in sched[0]) and
// run in S slots (sched[1 + slot]: the slot's job, -1 for none):
//   * prepare: the slot's job's loop condition, the end pair (a binary
//     search from the job's pair hint, anchor.get_end_pair's result on
//     ascending refs), the QC stops, the window's shape (a window the padded
//     shape cannot hold, or a job past its budget of windows, aborts the job
//     to the host path).  A job without a window leaves the slot, and the
//     warp takes the next job from the queue's head (a compare-and-swap, so
//     the head never passes J), until a job has a window or the queue is
//     empty; a new job's transitions go into the slot's row.  Then the
//     Viterbi inputs: the window's event levels (a strided gather from the
//     read's levels) and its kmers' mu, sigma and c (a copy from the job's
//     whole-window rows, so every value is the one the host path would
//     upload).  Which warp takes which job follows the order in which they
//     reach the head; the set of jobs taken in a round does not (the
//     shortest run from the head that holds a window for every free slot,
//     or the rest of the queue), nor does any job's state;
//   * consume: the round's traceback in forward order (the backtrack writes
//     it reversed), 32 cells at a time: a ballot of the kept cells (no K
//     state, not the re-emitted anchor event) and a popcount below the lane
//     give each kept row its place; rows past OUTPUT_STRIDE are cut unless
//     this is the last section; each kept row is written at the job's
//     cursor; the last kept row re-anchors the chain.
// What bounds it on the H100: neither bytes (a few KB a job a round: the
// window's levels and kmer rows written, the path read) nor operations; a
// round's launch is latency: a dependent binary search of ~log2(pairs)
// loads, then one pass over the window.  Its job is to keep the host out of
// the round: with it the chain runs prepare -> Viterbi fill -> backtrack ->
// consume on the stream with no fetch in between, and a finished job's slot
// is refilled in the same round.

#include "npt_common.cuh"

namespace {

constexpr int ALIGN_STRIDE = 100;   // eventalign.cpp:668
constexpr int OUTPUT_STRIDE = 50;   // eventalign.cpp:669
constexpr int WARPS = 4;            // slots per block
constexpr long long KMER_MASK = (1ll << 30) - 1;

// meta columns (ops/chain_step.py)
constexpr int M_POFF = 0, M_NPAIRS = 1, M_LOFF = 2, M_NLEV = 3, M_ROFF = 4,
              M_NRANK = 5, M_COFF = 6, M_NCLOSE = 7, M_LAST = 8, M_FWD = 9,
              M_REFOFF = 10, M_K = 11, M_OOFF = 12, M_OCAP = 13, N_META = 14;
// state columns; the last four count the work of the job's windows (the
// rounds with stride != 0): windows, DP cells as lo + hi * 2^30, path steps
constexpr int S_EV = 0, S_REF = 1, S_PAIR = 2, S_STATUS = 3, S_CURSOR = 4,
              S_STRIDE = 5, S_LAST = 6, S_WINDOWS = 7, S_CELLS = 8,
              S_CELLS_HI = 9, S_STEPS = 10, N_STATE = 11;
constexpr int CELLS_CARRY = 1 << 30;
constexpr int ACTIVE = 0, DONE = 1, ABORTED = 2;

// get_end_pair(pairs, q, hint) on ascending refs: the first index from
// hint whose ref exceeds q, minus one; hint - 1 when the hint's own ref
// does; the last pair when none does
__device__ __forceinline__ int end_pair(const int* refs, int n, int q,
                                        int hint) {
    if (hint >= n) return n - 1;
    if (refs[hint] > q) return hint - 1;
    int lo = hint, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (refs[mid] > q) hi = mid; else lo = mid + 1;
    }
    return lo - 1;
}

// the round's window of one job: its shape, or why it has none (stride 0)
struct Window {
    int status, nev, nk, stride, last, sidx;
};

__device__ __forceinline__ Window plan_window(
        const int* m, const int* s, const int* pairs_ref,
        const int* pairs_read, const int* closest, int budget, int TP,
        int KP) {
    Window w{s[S_STATUS], 1, 1, 0, 0, 0};
    const int start_ev = s[S_EV], start_ref = s[S_REF];
    if (w.status == ACTIVE && s[S_WINDOWS] >= budget) w.status = ABORTED;
    if (w.status != ACTIVE) return w;
    const int last_event = m[M_LAST];
    const bool more = m[M_FWD] ? start_ev < last_event
                               : start_ev > last_event;
    if (!more) {
        w.status = DONE;
        return w;
    }
    const int np = m[M_NPAIRS];
    const int* refs = pairs_ref + m[M_POFF];
    const int ep = end_pair(refs, np, start_ref + ALIGN_STRIDE, s[S_PAIR]);
    if (ep < 0) {
        w.status = ABORTED;
        return w;
    }
    const int end_ref = refs[ep];
    const int end_read = pairs_read[m[M_POFF] + ep];
    const int k = m[M_K];
    const int l = end_ref - start_ref + 1;
    if (end_read < 0 || l < 2 * k) {
        w.status = DONE;
        return w;
    }
    const int ev_stop = closest[m[M_COFF] + min(end_read, m[M_NCLOSE] - 1)];
    const int d = ev_stop - start_ev;
    const int ad = d < 0 ? -d : d;
    const int nkr = l - k + 1;
    const int si = start_ref - m[M_REFOFF];
    if (ad < 2) {
        w.status = DONE;
    } else if (ad + 1 > TP || nkr > KP || start_ev < 0 ||
               start_ev >= m[M_NLEV] || ev_stop < 0 ||
               ev_stop >= m[M_NLEV] || si < 0 || si + nkr > m[M_NRANK]) {
        w.status = ABORTED;
    } else {
        w.nev = ad + 1;
        w.nk = nkr;
        w.stride = d >= 0 ? 1 : -1;
        w.last = ep == np - 1;
        w.sidx = si;
    }
    return w;
}

// the queue's next job, or -1 once the head has reached J
__device__ __forceinline__ int take_job(int* head, int J) {
    int h = *(volatile int*)head;
    while (h < J) {
        const int seen = atomicCAS(head, h, h + 1);
        if (seen == h) return h;
        h = seen;
    }
    return -1;
}

__global__ void chain_step_prepare_kernel(
        const int* __restrict__ meta, int* __restrict__ state,
        const int* __restrict__ pairs_ref, const int* __restrict__ pairs_read,
        const int* __restrict__ closest, const float* __restrict__ levels_all,
        const float* __restrict__ tabs, int n_tab, int J, int S, int budget,
        int TP, int KP, float pad_c, const float* __restrict__ trans_all,
        float* __restrict__ trans, int* sched,
        float* __restrict__ levels, float* __restrict__ mu,
        float* __restrict__ sigma, float* __restrict__ c,
        int* __restrict__ n_events, int* __restrict__ n_kmers) {
    const int slot = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (slot >= S) return;
    int job = sched[1 + slot];
    bool fresh = false;
    Window w{ACTIVE, 1, 1, 0, 0, 0};
    while (job >= 0) {
        w = plan_window(meta + (size_t)job * N_META,
                        state + (size_t)job * N_STATE, pairs_ref, pairs_read,
                        closest, budget, TP, KP);
        if (w.stride != 0) break;
        // no window: the job says why and leaves the slot to the next
        __syncwarp();
        int next = -1;
        if (lane == 0) {
            int* s = state + (size_t)job * N_STATE;
            s[S_STATUS] = w.status;
            s[S_STRIDE] = 0;
            s[S_LAST] = 0;
            next = take_job(sched, J);
        }
        job = __shfl_sync(NPT_FULL_MASK, next, 0);
        fresh = true;
    }
    if (job >= 0) {
        const int* m = meta + (size_t)job * N_META;
        const int* s = state + (size_t)job * N_STATE;
        const float* lv = levels_all + m[M_LOFF] + s[S_EV];
        float* lrow = levels + (size_t)slot * TP;
        for (int t = lane; t < w.nev; t += 32) lrow[t] = lv[t * w.stride];
        const float* tm = tabs + m[M_ROFF] + w.sidx;
        const size_t row = (size_t)slot * KP;
        for (int i = lane; i < KP; i += 32) {
            const bool in = i < w.nk;
            mu[row + i] = in ? tm[i] : 0.0f;
            sigma[row + i] = in ? tm[n_tab + i] : 1.0f;
            c[row + i] = in ? tm[2 * (size_t)n_tab + i] : pad_c;
        }
        if (fresh && lane < 8)
            trans[(size_t)slot * 8 + lane] = trans_all[(size_t)job * 8 + lane];
    }
    __syncwarp();
    if (lane == 0) {
        sched[1 + slot] = job;
        n_events[slot] = w.nev;
        n_kmers[slot] = w.nk;
        if (job >= 0) {
            int* s = state + (size_t)job * N_STATE;
            s[S_STRIDE] = w.stride;
            s[S_LAST] = w.last;
            int cells = s[S_CELLS] + w.nev * w.nk;     // nev * nk <= TP * KP
            if (cells >= CELLS_CARRY) {
                cells -= CELLS_CARRY;
                s[S_CELLS_HI] += 1;
            }
            s[S_CELLS] = cells;
            s[S_WINDOWS] += 1;
        }
    }
}

__global__ void chain_step_consume_kernel(
        const int* __restrict__ meta, int* __restrict__ state,
        const int* __restrict__ pairs_ref, const int* __restrict__ sched,
        const long long* __restrict__ path, int W, int S,
        int* __restrict__ rows, int n_rows) {
    const int slot = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (slot >= S) return;
    const int job = sched[1 + slot];
    if (job < 0) return;                       // no job left for the slot
    const int* m = meta + (size_t)job * N_META;
    int* s = state + (size_t)job * N_STATE;
    const int stride = s[S_STRIDE];
    if (stride == 0) return;                   // no window this round
    const long long* p = path + (size_t)slot * W;
    const int n = (int)p[0];
    const int limit = s[S_LAST] ? 0x7fffffff : OUTPUT_STRIDE;
    const int start_ev = s[S_EV], start_ref = s[S_REF];
    const int cursor = s[S_CURSOR], cap = m[M_OCAP];
    int* out_ev = rows + m[M_OOFF];
    int* out_ref = out_ev + n_rows;
    int* out_st = out_ref + n_rows;
    const unsigned below = (1u << lane) - 1u;
    int kept = 0, last_ev = 0, last_ref = 0;
    for (int c0 = 0; c0 < n && kept < limit; c0 += 32) {
        const int i = c0 + lane;
        bool keep = false;
        int ev = 0, ref = 0, st = 0;
        if (i < n) {
            const long long cell = p[1 + (n - 1 - i)];
            const int off = (int)(cell >> 32);
            st = (int)(cell & 3);
            keep = st != 0 && off != 0;
            ev = start_ev + off * stride;
            ref = start_ref + (int)((cell >> 2) & KMER_MASK);
        }
        const int order = kept + __popc(__ballot_sync(NPT_FULL_MASK, keep)
                                        & below);
        keep = keep && order < limit;
        if (keep && cursor + order < cap) {
            out_ev[cursor + order] = ev;
            out_ref[cursor + order] = ref;
            out_st[cursor + order] = st == 2 ? 77 : 66;
        }
        const unsigned taken = __ballot_sync(NPT_FULL_MASK, keep);
        if (taken) {
            const int src = 31 - __clz(taken);
            last_ev = __shfl_sync(NPT_FULL_MASK, ev, src);
            last_ref = __shfl_sync(NPT_FULL_MASK, ref, src);
        }
        kept += __popc(taken);
    }
    __syncwarp();
    if (lane == 0) {
        s[S_STEPS] += n;
        if (kept == 0) {
            s[S_STATUS] = DONE;
        } else {
            const int hint = end_pair(pairs_ref + m[M_POFF], m[M_NPAIRS],
                                      last_ref, s[S_PAIR]);
            if (cursor + kept > cap || hint < 0) {
                s[S_STATUS] = ABORTED;
            } else {
                s[S_EV] = last_ev;
                s[S_REF] = last_ref;
                s[S_PAIR] = hint;
                s[S_CURSOR] = cursor + kept;
            }
        }
    }
}

}  // namespace

// op 0: prepare (path, W, rows, n_rows unused); op 1: consume (the pairs'
// read side, closest, levels, tabs, the transitions, the budget and the
// Viterbi inputs unused)
extern "C" int npt_launch_chain_step(
        int op, const int* meta, int* state, const int* pairs_ref,
        const int* pairs_read, const int* closest, const float* levels_all,
        const float* tabs, int n_tab, int J, int S, int budget, int TP,
        int KP, float pad_c, const float* trans_all, float* trans,
        int* sched, float* levels, float* mu, float* sigma, float* c,
        int* n_events, int* n_kmers, const long long* path, int W, int* rows,
        int n_rows, void* stream) {
    if (op != 0 && op != 1) return (int)cudaErrorInvalidValue;
    if (S > 0) {
        const int blocks = (S + WARPS - 1) / WARPS;
        if (op == 0)
            chain_step_prepare_kernel<<<blocks, WARPS * 32, 0,
                                        (cudaStream_t)stream>>>(
                meta, state, pairs_ref, pairs_read, closest, levels_all,
                tabs, n_tab, J, S, budget, TP, KP, pad_c, trans_all, trans,
                sched, levels, mu, sigma, c, n_events, n_kmers);
        else
            chain_step_consume_kernel<<<blocks, WARPS * 32, 0,
                                        (cudaStream_t)stream>>>(
                meta, state, pairs_ref, sched, path, W, S, rows, n_rows);
    }
    return (int)cudaGetLastError();
}
