// Shared helpers for the nanopolish_tpu_torch CUDA kernels.
//
// Every kernel is built with -fmad=false and IEEE division, and spells out
// its roundings with the _rn intrinsics: the DP fills must reproduce the
// plain PyTorch versions bit for bit, so a*b+c is fused exactly where the
// reference's compiled f32 expression fuses it (__fmaf_rn) and nowhere else.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NPT_FULL_MASK 0xffffffffu

__device__ __forceinline__ float npt_neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float npt_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float npt_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float npt_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float npt_div(float a, float b) { return __fdiv_rn(a, b); }

// max with the comparison semantics of torch.maximum on non-NaN inputs
__device__ __forceinline__ float npt_max(float a, float b) { return a > b ? a : b; }

// Gaussian log-density as the reference's compiled fills evaluate it:
// a = (x - mu) / sigma; fma(-0.5*a, a, c) with c = LOG_INV_SQRT_2PI - log(sigma).
__device__ __forceinline__ float npt_log_normal(float x, float mu, float sigma, float c) {
    float a = npt_div(npt_sub(x, mu), sigma);
    return __fmaf_rn(npt_mul(-0.5f, a), a, c);
}

// x of the lane d below in a group of W lanes of the warp (gl: the lane's
// place in its group), -inf in the group's lanes below d
template <int W = 32>
__device__ __forceinline__ float npt_shfl_prev(float x, int d, int gl) {
    const float u = __shfl_up_sync(NPT_FULL_MASK, x, d, W);
    return gl >= d ? u : npt_neg_inf();
}

__device__ __forceinline__ int npt_clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// 16-byte asynchronous copy global -> shared (cp.async.cg: through L2,
// bypassing L1); both addresses 16-byte aligned.  Copies issued by a
// thread since its last commit form one group; wait_all waits for all of
// the thread's groups, so a warp that shares what it staged also needs a
// __syncwarp() after it.
__device__ __forceinline__ void npt_cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}
// the same for 4 bytes (cp.async.ca: through L1); both addresses 4-byte
// aligned
__device__ __forceinline__ void npt_cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void npt_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void npt_cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// named barrier id shared by nthreads threads (a multiple of 32): sync
// waits for the other participants, arrive counts this warp and goes on.
// Both order this thread's earlier memory accesses before the barrier
// completes for every participant.
__device__ __forceinline__ void npt_bar_sync(int id, int nthreads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(nthreads) : "memory");
}
__device__ __forceinline__ void npt_bar_arrive(int id, int nthreads) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(nthreads) : "memory");
}
