// Shared device helpers for the motion-estimation kernels: the HEVC
// 8-tap luma filter (the one table of its taps) and index clamping.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// HEVC luma taps: a constant expression, so that fully unrolled loops
// with a constant phase fold them (me_refine's vsweep skips the zero
// taps); with a run-time phase they are a few selects. Phase 3 mirrors
// phase 1.
__host__ __device__ constexpr int luma_tap1(int k) {
    return k == 0 ? -1 : k == 1 ? 4 : k == 2 ? -10 : k == 3 ? 58
         : k == 4 ? 17 : k == 5 ? -5 : k == 6 ? 1 : 0;
}
__host__ __device__ constexpr int luma_tap(int ph, int k) {
    return ph == 0 ? (k == 3 ? 64 : 0)
         : ph == 1 ? luma_tap1(k)
         : ph == 3 ? luma_tap1(7 - k)
         : (k == 3 || k == 4) ? 40 : (k == 2 || k == 5) ? -11
         : (k == 1 || k == 6) ? 4 : -1;
}
