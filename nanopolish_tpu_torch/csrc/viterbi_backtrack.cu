// R9 profile-HMM Viterbi traceback (kernel 4 of the Viterbi).
//
// Replaces: nanopolish_tpu/ops/pallas_profile_hmm.py _vit_backtrack_kernel
// (:758) together with the host expansion _expand_backtrack (:899).
// Spec: profile_hmm_align_r9 (nanopolish_profile_hmm_r9.cpp:73-204);
// plain version: nanopolish_tpu_torch/ops/profile_hmm.py
// viterbi_backtrack_plain, which this kernel matches exactly.
//
// What bounds it on the H100: each step's trace byte is chosen by the step
// before, so a segment's walk is a chain of dependent loads: latency, not
// bytes (one byte per step) or operations.  Read straight from L2, a step
// costs an L2 round trip (~400-500 cycles).  The design moves that chain
// into shared memory:
//   * one warp per segment, WARPS segments per block, so a 32-segment
//     eventalign wavefront launch spreads over 8 SMs;
//   * the walk only ever moves to a lower row or a lower kmer, so the warp
//     stages the tile it can reach next: rows [r - R + 1, r] across a kmer
//     window that ends at the walk's kmer (its 16-byte group).  The window
//     is the whole row up to 256 kmers, else 256 kmers; R fills TILE_BYTES
//     (ops/profile_hmm_viterbi.backtrack_tile computes both).  Every lane
//     issues its share of 16-byte cp.async copies (trace rows are KP bytes,
//     KP a power of two >= 32, so every copy is aligned);
//   * the tile is double-buffered: when the walk enters a tile, the tile of
//     the R rows below (window ending at the walk's kmer then) is already
//     on its way into the other buffer, and is waited for only when the
//     walk leaves the current one;
//   * all 32 lanes walk the same path (each step a broadcast shared-memory
//     load and the decode), so no lane waits on another for the state; lane
//     i keeps path entry i of each group of 32, and the group is written as
//     32 coalesced 8-byte stores;
//   * a step is short: the decode is a nibble of MOVES picked by the
//     state's move field (shift, mask, shift, no branch), the tile offset
//     moves by the step, and one uniform branch leaves the step for a tile
//     switch or the end of the walk.
// A K-state run moves along the kmer axis without consuming a row; if it
// leaves the window, the warp stages (r, ki) at once and waits for it.  On
// eventalign segments (KP 128) the window is the whole row, so that never
// happens; it takes a run of more than 240 kmers inside one tile at KP >=
// 512 (tests/backtrack_tiles.py counts these refills).  Each step is
// written as one packed int64 (event << 32 | kmer << 2 | state: 30 bits of
// kmer), which lets the host fetch a whole batch of paths in one copy.

#include "npt_common.cuh"

namespace {

constexpr int ST_K = 0, ST_B = 1, ST_M = 2;
// a move (FROM_SAME_M 0, FROM_PREV_M 1, FROM_SAME_B 2, FROM_PREV_B 3,
// FROM_PREV_K 4, FROM_SOFT 5; 6 and 7 go to K like 4 but keep the kmer,
// as the reference's decode does) as one nibble: the next state in bits
// 0-1, "one kmer lower" in bit 2, "soft clip: stop" in bit 3
constexpr unsigned MOVES = 0x845162u;
constexpr int WARPS = 4;             // segments per block
constexpr int TILE_BYTES = 8192;     // one staged tile; two per warp
constexpr int SMEM_BYTES = WARPS * 2 * TILE_BYTES;

// rows [r_lo, r_hi] x kmers [k_lo, k_lo + W) of the trace, staged in a
// buffer at (row - r_lo) * W + (kmer - k_lo); r_hi < r_lo when empty
struct Tile {
    int r_lo, r_hi, k_lo;
};

// stage rows [max(0, r - R + 1), r] x the W-kmer window that ends at
// ki's 16-byte group (W <= KP, both powers of two) into buf
__device__ __forceinline__ Tile stage(uint8_t* buf, const uint8_t* trb,
                                      int KP, int W, int R, int r, int ki,
                                      int lane) {
    Tile t;
    t.r_hi = r;
    t.r_lo = max(0, r - R + 1);
    t.k_lo = max(0, min(KP, (ki | 15) + 1) - W);
    const int shift = __ffs(W) - 1 - 4;      // log2(16-byte copies per row)
    const int n = (t.r_hi - t.r_lo + 1) << shift;
    for (int i = lane; i < n; i += 32) {
        const int rr = i >> shift, cc = (i & ((1 << shift) - 1)) << 4;
        npt_cp_async16(buf + rr * W + cc,
                       trb + (size_t)(t.r_lo + rr) * KP + t.k_lo + cc);
    }
    npt_cp_async_commit();
    return t;
}

__global__ void __launch_bounds__(WARPS * 32) viterbi_backtrack_kernel(
        const uint8_t* __restrict__ trace, int T, int KP, int W, int R,
        const int* __restrict__ nev_a, const int* __restrict__ nk_a, int B,
        long long* __restrict__ path) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + warp;
    if (b >= B) return;
    uint8_t* const bufs = smem + warp * 2 * TILE_BYTES;
    const int L = T + KP;
    const uint8_t* trb = trace + (size_t)b * T * KP;
    long long* out = path + (size_t)b * (1 + L);
    int row = nev_a[b], ki = nk_a[b] - 1, len = 0;
    long long mine = 0;
    if (row > 0 && ki >= 0) {
        Tile cur = stage(bufs, trb, KP, W, R, row - 1, ki, lane);
        npt_cp_async_wait_all();
        __syncwarp();
        Tile nxt = {0, -1, 0};
        if (cur.r_lo > 0)
            nxt = stage(bufs + TILE_BYTES, trb, KP, W, R, cur.r_lo - 1, ki,
                        lane);
        int cb = 0;                              // the buffer cur is in
        int off = (row - 1 - cur.r_lo) * W + (ki - cur.k_lo);
        int st = ST_M, sh = 0, msk = 7, msh = 2, drow = 1;
        for (;;) {
            const int byte = bufs[off];
            if ((len & 31) == lane)
                mine = ((long long)(row - 1) << 32) | ((long long)ki << 2) | st;
            if ((len & 31) == 31) out[len - 30 + lane] = mine;
            ++len;
            // the state's move field of the byte, (byte >> sh) & msk, picks
            // a nibble of MOVES (B's one bit picks move 0 or 2)
            const int info = (MOVES >> (((byte >> sh) & msk) << msh)) & 15;
            const int dki = (info >> 2) & 1;
            row -= drow;
            ki -= dki;
            off -= drow * W + dki;
            st = info & 3;
            sh = st == ST_M ? 0 : (st == ST_B ? 3 : 4);
            msk = st == ST_B ? 1 : 7;
            msh = st == ST_B ? 3 : 2;
            drow = st != ST_K;
            if ((info & 8) || ki < cur.k_lo || row - 1 < cur.r_lo || len >= L) {
                if ((info & 8) || ki < 0 || row <= 0 || len >= L) break;
                npt_cp_async_wait_all();         // the walk left the tile
                __syncwarp();                    // and every lane read it
                cb ^= 1;
                const int r = row - 1;
                if (r < nxt.r_lo || r > nxt.r_hi || ki < nxt.k_lo) {
                    nxt = stage(bufs + cb * TILE_BYTES, trb, KP, W, R, r, ki,
                                lane);           // left the window
                    npt_cp_async_wait_all();
                    __syncwarp();
                }
                cur = nxt;
                nxt = Tile{0, -1, 0};
                if (cur.r_lo > 0)
                    nxt = stage(bufs + (cb ^ 1) * TILE_BYTES, trb, KP, W, R,
                                cur.r_lo - 1, ki, lane);
                off = cb * TILE_BYTES + (r - cur.r_lo) * W + (ki - cur.k_lo);
            }
        }
    }
    const int rem = len & 31;                    // the last, partial group
    if (lane < rem) out[1 + len - rem + lane] = mine;
    if (lane == 0) out[0] = len;
    npt_cp_async_wait_all();                     // no copy outlives the block
}

}  // namespace

extern "C" int npt_launch_viterbi_backtrack(
        const uint8_t* trace, int T, int KP, int W, int R, const int* nev,
        const int* nk, int B, long long* path, void* stream) {
    if (W < 32 || W > KP || (W & (W - 1)) || R < 1 || R * W > TILE_BYTES)
        return (int)cudaErrorInvalidValue;
    if (B > 0) {
        cudaError_t err = cudaFuncSetAttribute(
            viterbi_backtrack_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        viterbi_backtrack_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32,
                                   SMEM_BYTES, (cudaStream_t)stream>>>(
            trace, T, KP, W, R, nev, nk, B, path);
    }
    return (int)cudaGetLastError();
}
