// me_refine: quarter-pel motion refinement for every n x n source block.
//
// Replaces the TPU kernel kvazaar_tpu/ops/pallas_me.py me_refine
// (pallas_call at :346; me_refine :367, make_refine_kernel :170,
// _me_refine_chunk :313); the arithmetic is that of the reference's XLA
// twin kvazaar_tpu/models/inter_md.py _me_xla_one, and the plain version
// is kvazaar_tpu_torch/ops/me.py me_refine_plain.
//
// Per block: for each candidate full-pel MV (clamped to +-96), 49 SADs of
// the +-3 integer window plus the prior (lam64 * PRIOR_INT) >> 8, first
// minimum in (candidate, dy, dx) order; then the SATD (8x8 Hadamard
// tiles, (sum|t| + 2) >> 2) at all 49 quarter-pel offsets in [-3, 3]^2
// around the winner with the exact HEVC 8-tap luma filter, plus
// (lam64 * PRIOR_QPEL) >> 8, first minimum in (qy, qx) order. Outputs the
// MV (qpel), the SATD without prior and the winning prediction.
//
// Bound on an H100: operations. chip_smoke.py's refine_work counts about
// 3.5e10 operations for one 1080p B frame's 8 launches against a few
// tens of MB of input. The design below runs that work (filter, rounding,
// Hadamard, SAD) in float32 on the FP32 pipe, and an SM issues at most
// 128 lanes a clock on any pipe, so at 132 SMs x 128 lanes x 2 (a
// multiply-add counts 2) x 1.98 GHz = 66.9e12 operations/s the bound is
// about 0.53 ms, and the memory bound a ninth of that. The sub-pel sweep
// (49 offsets x vertical 8-tap x SATD) is 68-85% of the counted work.
//
// Design, against what bounded the first version (one block per source
// block, everything int32, all seven horizontal variants in shared
// memory, 168 KB a block at n = 64, one thread scanning the sums):
// 1. Sub-pel sweep. The seven horizontal variants qx are made one at a
//    time into one (n+8) x n buffer. A thread owns one column of an 8x8
//    tile: it loads the 16 rows that the seven vertical offsets qy read
//    once and makes all seven tile columns from registers (16 shared
//    loads for 56 outputs, not 8 a output). Filter multiply-adds, the
//    rounding and the Hadamard butterflies run in float32 on the FP32
//    pipe (128 lanes an SM against 64 INT32 lanes): every value is an
//    integer below 2^24 (bounds at hpass and vsweep), so float32 is
//    exact; the per-offset sums are exact integers (shared atomics).
// 2. Integer SAD. A thread holds a row strip of 8 source pixels in
//    registers and reuses each window row across the 7 dx shifts (14
//    shared loads per 56 |differences|); |w - s| accumulates in float32
//    (exact, sums below 2^24). n = 8 packs 16 source blocks (8 threads
//    each) and n = 16 packs 4 (a warp each) into 128-thread blocks; the
//    49 partial sums reduce by halving over the lanes (each step sends
//    half of what a lane holds), not by 49 full warp reductions.
// 3. Argmin. Each lane makes 64-bit keys (cost << 16) | order, order
//    being the position in the scan ((c * 49 + dy * 7 + dx), or
//    ((qy + 3) * 7 + qx + 3)), and a warp min picks the smallest: the
//    first minimum of the reference's strict-< scan, with no serial
//    thread.
// The reference plane is read unpadded with every index clamped, which
// equals edge padding. No TMA, no tensor cores: the Hadamard would be
// exact in fp16 mma.sync, and packed 8-bit SIMD SADs are a later step.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "me_common.cuh"

namespace {

// MV-cost priors by |delta| 0..3: PRIOR_INT (0, 2, 3, 3) and
// PRIOR_QPEL (0, 1, 2, 2)
__device__ __forceinline__ int prior_int(int a) {
    return a == 0 ? 0 : (a == 1 ? 2 : 3);
}
__device__ __forceinline__ int prior_qpel(int a) {
    return a == 0 ? 0 : (a == 1 ? 1 : 2);
}

template <int N>
struct RefineGeom {
    static constexpr int WI = N + 6;     // integer-refine window side
    static constexpr int WS = N + 8;     // sub-pel window side
    static constexpr int WSTR = N + 9;   // window row stride (odd)
    static constexpr int HSTR = N + 1;   // horizontal-pass row stride (odd)
    static constexpr int SSTR = N + 1;   // source row stride (odd)
    static constexpr int STRIPS = N * N / 8;   // 8-pixel strips a block
    // threads per source block, source blocks per thread block
    static constexpr int TPB = STRIPS < 256 ? STRIPS : 256;
    static constexpr int P = TPB < 128 ? 128 / TPB : 1;
    static constexpr int THREADS = P * TPB;
    // lanes of one reduction group: the source block's threads within a
    // warp
    static constexpr int LG = TPB < 32 ? TPB : 32;
    static constexpr int WARPS = TPB / 32;   // warps per source block
    // shared words per source block: source, window, one horizontal
    // variant, 49 sub-pel sums, warp partials of the SAD sums
    static constexpr int PER = N * SSTR + WS * WSTR + WS * HSTR + 49
                               + (WARPS > 1 ? 64 * WARPS : 0);
    static constexpr int SMEM_WORDS = P * PER;
    static_assert(TPB % 8 == 0 && THREADS % 32 == 0, "lane groups");
    static_assert(WI <= WS, "one window buffer serves both phases");
};

// synchronise the threads of one source block (a warp holds whole
// source blocks when they have 32 threads or fewer)
template <int N>
__device__ __forceinline__ void group_sync() {
    if (RefineGeom<N>::TPB <= 32)
        __syncwarp();
    else
        __syncthreads();
}

// order is the position in the scan: below 2^16, so the wrapper takes at
// most 65536 / 49 = 1337 candidates (order c * 49 + o); the cost (below
// 2^24) fits in the 47 bits above it
__device__ __forceinline__ long long cost_key(int cost, int order) {
    return ((long long)cost << 16) | order;
}

// min of a key over the LG lanes of a reduction group (xor butterflies)
template <int LG>
__device__ __forceinline__ long long group_min(long long k) {
#pragma unroll
    for (int m = 1; m < LG; m <<= 1) {
        const long long o = __shfl_xor_sync(0xffffffffu, k, m);
        k = o < k ? o : k;
    }
    return k;
}

// floor(a / 64) then the HEVC rounding (v + 32) >> 6 and the clamp to
// [0, maxv], in float: exact for any integer |a| < 2^24 (scaling by a
// power of two and floorf are exact there)
__device__ __forceinline__ float round_pred(float a, float maxv) {
    const float v = floorf(a * 0.015625f);
    return fminf(fmaxf(floorf((v + 32.f) * 0.015625f), 0.f), maxv);
}

// Sums the 49 per-lane partials over the LG lanes of the reduction group
// by halving: at each xor step a lane keeps one half of what it holds and
// sends the other (25 + 13 + 7 + 4 + 2 shuffles over 32 lanes, 45 over
// 8, against 49 per step for full reductions); the xor distance halves
// from LG / 2 to 1, one template level a step, so every index is a
// constant. On return v[i], i < nreal, holds the group total of offset
// base + i; every offset is held by exactly one lane of the group.
template <int LG, int C = 49>
struct HalvingSum {
    static constexpr int H = (C + 1) / 2;   // slots kept by each lane
    static constexpr int M = LG / 2;        // xor distance of this step
    static constexpr int R = HalvingSum<LG / 2, H>::R;   // slots at the end

    __device__ static __forceinline__ void run(float (&v)[49], int lane,
                                               int& base, int& nreal) {
        const bool upper = (lane & M) != 0;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const float lo = v[i];
            const float hi = i + H < C ? v[i + H] : 0.f;
            const float got =
                __shfl_xor_sync(0xffffffffu, upper ? lo : hi, M);
            v[i] = (upper ? hi : lo) + got;
        }
        base += upper ? H : 0;
        nreal = upper ? max(nreal - H, 0) : min(nreal, H);
        HalvingSum<LG / 2, H>::run(v, lane, base, nreal);
    }
};

template <int C>
struct HalvingSum<1, C> {
    static constexpr int R = C;
    __device__ static __forceinline__ void run(float (&)[49], int, int&,
                                               int&) {}
};

// Horizontal 8-tap pass of variant qx over the (N+8) x (N+8) window:
// h[row][x] = sum_k f[qx & 3][k] * win[row][c0 + k + x], c0 = 1 + (qx >> 2),
// for rows 0..N+7 and x 0..N-1. A thread makes 8 outputs of one row from
// 15 window values. Bounds (8-bit): h in [-24 * 255, 88 * 255] =
// [-6120, 22440]; 4x that at 10 bits, far below 2^24.
template <int N>
__device__ __forceinline__ void hpass(const float* s_win, float* s_h, int qx,
                                      int t) {
    using G = RefineGeom<N>;
    const int c0 = 1 + (qx >> 2), ph = qx & 3;
    float f[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = (float)luma_tap(ph, k);
    for (int i = t; i < G::WS * (N / 8); i += G::TPB) {
        const int row = i % G::WS, x0 = (i / G::WS) * 8;
        const float* w = s_win + row * G::WSTR + c0 + x0;
        float wv[15];
#pragma unroll
        for (int j = 0; j < 15; ++j) wv[j] = w[j];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float a = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) a = fmaf(f[k], wv[j + k], a);
            s_h[row * G::HSTR + x0 + j] = a;
        }
    }
}

// The 7 vertical offsets qy of variant qx and their SATDs. A thread owns
// one column x of an 8x8 tile: it loads the 16 rows of h that all seven
// qy read (r0 + k + i, r0 in {0, 1}) once, makes the tile column for each
// qy with constant taps, and does the column butterflies in registers and
// the row butterflies with the 7 other lanes of its tile (xor 1, 2, 4).
// Bounds (8-bit): |vertical sum| <= 112 * 22440 < 2.6e6; d = src - pred
// in [-255, 255]; |Hadamard output| <= 64 * 255 = 16320; a tile's sum of
// |t| <= 64 * 16320 < 1.05e6. At 10 bits each is 4x larger, below 2^24 =
// 16,777,216, so float32 holds every value exactly.
template <int N>
__device__ __forceinline__ void vsweep(const float* s_h, const float* s_src,
                                       int qx, float maxv, int* s_sum,
                                       int t) {
    using G = RefineGeom<N>;
    const int lane = threadIdx.x & 31;
    for (int s = t; s < G::STRIPS; s += G::TPB) {
        const int x = s % N, y0 = (s / N) * 8;
        float hv[16], sv[8];
#pragma unroll
        for (int r = 0; r < 16; ++r) hv[r] = s_h[(y0 + r) * G::HSTR + x];
#pragma unroll
        for (int i = 0; i < 8; ++i) sv[i] = s_src[(y0 + i) * G::SSTR + x];
#pragma unroll
        for (int qi = 0; qi < 7; ++qi) {
            const int qy = qi - 3, r0 = 1 + (qy >> 2), ph = qy & 3;
            float d[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float a = 0.f;
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    if (luma_tap(ph, k) != 0)
                        a = fmaf((float)luma_tap(ph, k), hv[r0 + k + i], a);
                d[i] = sv[i] - round_pred(a, maxv);
            }
#pragma unroll
            for (int h = 1; h < 8; h <<= 1)
#pragma unroll
                for (int i = 0; i < 8; i += 2 * h)
#pragma unroll
                    for (int j = i; j < i + h; ++j) {
                        const float u = d[j], v = d[j + h];
                        d[j] = u + v;
                        d[j + h] = u - v;
                    }
#pragma unroll
            for (int m = 1; m < 8; m <<= 1)
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float o = __shfl_xor_sync(0xffffffffu, d[i], m);
                    d[i] = (lane & m) ? o - d[i] : d[i] + o;
                }
            float a = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) a += fabsf(d[i]);
            a += __shfl_xor_sync(0xffffffffu, a, 1);
            a += __shfl_xor_sync(0xffffffffu, a, 2);
            a += __shfl_xor_sync(0xffffffffu, a, 4);
            if ((lane & 7) == 0)
                atomicAdd(&s_sum[qi * 7 + qx + 3], ((int)a + 2) >> 2);
        }
    }
}

template <int N>
__global__ void __launch_bounds__(RefineGeom<N>::THREADS)
me_refine_kernel(const int* __restrict__ ref, int H, int W,
                 const int* __restrict__ src, const int* __restrict__ cands,
                 int K, const int* __restrict__ lam_p, int L, int cols,
                 int maxv, int* __restrict__ mv_out,
                 int* __restrict__ satd_out, int* __restrict__ pred_out) {
    using G = RefineGeom<N>;
    extern __shared__ float smem[];
    const int g = threadIdx.x / G::TPB, t = threadIdx.x % G::TPB;
    const int lane = threadIdx.x & 31, warp = t >> 5, lt = t % G::LG;
    float* s_src = smem + g * G::PER;
    float* s_win = s_src + N * G::SSTR;
    float* s_h = s_win + G::WS * G::WSTR;
    int* s_sum = reinterpret_cast<int*>(s_h + G::WS * G::HSTR);
    float* s_red = reinterpret_cast<float*>(s_sum + 49);

    // a tail group past the last source block repeats the last one and
    // writes nothing (it still takes part in every synchronisation)
    const int bidx = blockIdx.x * G::P + g;
    const bool live = bidx < L;
    const int b = live ? bidx : L - 1;
    const int y0 = (b / cols) * N, x0 = (b % cols) * N;
    const int lam64 = lam_p[0];
    const int* srcb = src + (size_t)b * N * N;
    for (int i = t; i < N * N; i += G::TPB)
        s_src[(i / N) * G::SSTR + i % N] = (float)srcb[i];

    // ---- integer refine: 49 SADs per candidate -------------------------
    long long best = LLONG_MAX;
    for (int c = 0; c < K; ++c) {
        const int cx = clampi(cands[((size_t)b * K + c) * 2 + 0], -96, 96);
        const int cy = clampi(cands[((size_t)b * K + c) * 2 + 1], -96, 96);
        group_sync<N>();
        for (int i = t; i < G::WI * G::WI; i += G::TPB) {
            const int r = i / G::WI, q = i % G::WI;
            const int yy = clampi(y0 + cy - 3 + r, 0, H - 1);
            const int xx = clampi(x0 + cx - 3 + q, 0, W - 1);
            s_win[r * G::WSTR + q] = (float)ref[(size_t)yy * W + xx];
        }
        group_sync<N>();
        float acc[49];
#pragma unroll
        for (int o = 0; o < 49; ++o) acc[o] = 0.f;
        for (int s = t; s < G::STRIPS; s += G::TPB) {
            const int y = s % N, xs = (s / N) * 8;
            float sv[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) sv[j] = s_src[y * G::SSTR + xs + j];
#pragma unroll
            for (int dy = 0; dy < 7; ++dy) {
                const float* w = s_win + (y + dy) * G::WSTR + xs;
                float wv[14];
#pragma unroll
                for (int j = 0; j < 14; ++j) wv[j] = w[j];
#pragma unroll
                for (int dx = 0; dx < 7; ++dx)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[dy * 7 + dx] += fabsf(wv[j + dx] - sv[j]);
            }
        }
        // totals per offset (exact: below 64 * 64 * 255 < 2^24), then keys
        int base = 0, nreal = 49;
        HalvingSum<G::LG>::run(acc, lt, base, nreal);
        constexpr int R = HalvingSum<G::LG>::R;
        long long k = LLONG_MAX;
        if (G::WARPS > 1) {
#pragma unroll
            for (int i = 0; i < R; ++i)
                if (i < nreal) s_red[warp * 64 + base + i] = acc[i];
            group_sync<N>();
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int o = lane + 32 * i;
                if (o < 49) {
                    float v = 0.f;
#pragma unroll
                    for (int w = 0; w < G::WARPS; ++w) v += s_red[w * 64 + o];
                    const int prior = prior_int(abs(o / 7 - 3))
                                      + prior_int(abs(o % 7 - 3));
                    const long long kk = cost_key(
                        (int)v + ((lam64 * prior) >> 8), c * 49 + o);
                    k = kk < k ? kk : k;
                }
            }
        } else {
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const int o = base + i;
                if (i < nreal) {
                    const int prior = prior_int(abs(o / 7 - 3))
                                      + prior_int(abs(o % 7 - 3));
                    const long long kk = cost_key(
                        (int)acc[i] + ((lam64 * prior) >> 8), c * 49 + o);
                    k = kk < k ? kk : k;
                }
            }
        }
        k = group_min<G::LG>(k);
        best = k < best ? k : best;
    }
    const int ord = (int)(best & 0xffff);
    const int cw = ord / 49, ow = ord % 49;
    const int mx = clampi(cands[((size_t)b * K + cw) * 2 + 0], -96, 96)
                   + ow % 7 - 3;
    const int my = clampi(cands[((size_t)b * K + cw) * 2 + 1], -96, 96)
                   + ow / 7 - 3;

    // ---- sub-pel sweep around the integer winner ----------------------
    group_sync<N>();
    for (int i = t; i < G::WS * G::WS; i += G::TPB) {
        const int r = i / G::WS, q = i % G::WS;
        const int yy = clampi(y0 + my - 4 + r, 0, H - 1);
        const int xx = clampi(x0 + mx - 4 + q, 0, W - 1);
        s_win[r * G::WSTR + q] = (float)ref[(size_t)yy * W + xx];
    }
    for (int o = t; o < 49; o += G::TPB) s_sum[o] = 0;
    group_sync<N>();
    const float maxvf = (float)maxv;
    for (int qx = -3; qx <= 3; ++qx) {
        hpass<N>(s_win, s_h, qx, t);
        group_sync<N>();
        vsweep<N>(s_h, s_src, qx, maxvf, s_sum, t);
        group_sync<N>();
    }
    long long k = LLONG_MAX;
    for (int o = lt; o < 49; o += G::LG) {
        const int prior = prior_qpel(abs(o / 7 - 3))
                          + prior_qpel(abs(o % 7 - 3));
        const long long kk = cost_key(s_sum[o] + ((lam64 * prior) >> 8), o);
        k = kk < k ? kk : k;
    }
    k = group_min<G::LG>(k);
    const int ob = (int)(k & 0xffff);
    const int qy = ob / 7 - 3, qx = ob % 7 - 3;
    if (t == 0 && live) {
        mv_out[(size_t)b * 2 + 0] = mx * 4 + qx;
        mv_out[(size_t)b * 2 + 1] = my * 4 + qy;
        satd_out[b] = s_sum[ob];
    }
    // the winner's prediction: its horizontal variant again, then the
    // vertical pass per pixel (the last sweep's readers are done: the
    // loop ended on a group_sync)
    hpass<N>(s_win, s_h, qx, t);
    group_sync<N>();
    const int r0 = 1 + (qy >> 2), ph = qy & 3;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (float)luma_tap(ph, j);
    int* predb = pred_out + (size_t)b * N * N;
    for (int p = t; p < N * N; p += G::TPB) {
        const int y = p / N, x = p % N;
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            a = fmaf(f[j], s_h[(r0 + j + y) * G::HSTR + x], a);
        if (live) predb[p] = (int)round_pred(a, maxvf);
    }
}

template <int N>
cudaError_t prepare(size_t* smem) {
    *smem = sizeof(float) * RefineGeom<N>::SMEM_WORDS;
    return cudaFuncSetAttribute(me_refine_kernel<N>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
}

template <int N>
cudaError_t launch(const int* ref, int H, int W, const int* src,
                   const int* cands, int K, const int* lam, int L, int cols,
                   int maxv, int* mv, int* satd, int* pred,
                   cudaStream_t stream) {
    using G = RefineGeom<N>;
    size_t smem;
    cudaError_t e = prepare<N>(&smem);
    if (e != cudaSuccess) return e;
    if (L > 0)
        me_refine_kernel<N><<<(L + G::P - 1) / G::P, G::THREADS, smem,
                              stream>>>(ref, H, W, src, cands, K, lam, L,
                                        cols, maxv, mv, satd, pred);
    return cudaGetLastError();
}

template <int N>
cudaError_t info(int* out) {
    using G = RefineGeom<N>;
    size_t smem;
    cudaError_t e = prepare<N>(&smem);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, me_refine_kernel<N>, G::THREADS, smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, me_refine_kernel<N>);
    if (e != cudaSuccess) return e;
    out[0] = blocks;
    out[1] = G::THREADS;
    out[2] = G::P;
    out[3] = (int)smem;
    out[4] = a.numRegs;
    out[5] = (int)a.localSizeBytes;
    return cudaSuccess;
}

}  // namespace

// Launch geometry of the size-n kernel: out[0..5] = blocks per SM the
// launch achieves (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// threads per block, source blocks per block, dynamic shared bytes per
// block, registers per thread, local (spill) bytes per thread.
extern "C" int kvz_me_refine_info(int n, int* out) {
    switch (n) {
        case 8: return info<8>(out);
        case 16: return info<16>(out);
        case 32: return info<32>(out);
        case 64: return info<64>(out);
        default: return cudaErrorInvalidValue;
    }
}

extern "C" int kvz_me_refine(const void* ref, int H, int W, const void* src,
                             const void* cands, int K, const void* lam,
                             int L, int n, int cols, int maxv, void* mv,
                             void* satd, void* pred, void* stream) {
    const int* r = static_cast<const int*>(ref);
    const int* s = static_cast<const int*>(src);
    const int* c = static_cast<const int*>(cands);
    const int* l = static_cast<const int*>(lam);
    int* m = static_cast<int*>(mv);
    int* sd = static_cast<int*>(satd);
    int* p = static_cast<int*>(pred);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (n) {
        case 8: return launch<8>(r, H, W, s, c, K, l, L, cols, maxv, m, sd, p, st);
        case 16: return launch<16>(r, H, W, s, c, K, l, L, cols, maxv, m, sd, p, st);
        case 32: return launch<32>(r, H, W, s, c, K, l, L, cols, maxv, m, sd, p, st);
        case 64: return launch<64>(r, H, W, s, c, K, l, L, cols, maxv, m, sd, p, st);
        default: return cudaErrorInvalidValue;
    }
}
