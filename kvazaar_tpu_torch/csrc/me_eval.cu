// me_eval: exact evaluation of K candidate pairs (list 0 MV and
// reference, list 1 MV and reference) per source block: both 14-bit
// predictions, their two uni-prediction SATDs and the SATD of their exact
// bi-prediction average. In its one-list mode (P slices: no list 1) it
// evaluates K single candidates (MV and reference) per block: one
// prediction and its SATD.
//
// Replaces the TPU kernel kvazaar_tpu/ops/pallas_me.py me_eval
// (pallas_call at :467; me_eval :489, make_eval_kernel :395,
// _me_eval_chunk :444) together with the bi-average SATD that the
// reference computes beside it; the arithmetic is that of the XLA branch
// of kvazaar_tpu/models/inter_md.py _eval_exact (_mc_luma_sel +
// _satd_tiles) for each list, then _bi_avg + _satd_tiles. The plain
// version is kvazaar_tpu_torch/ops/me.py me_eval_plain.
//
// Per block b and pair k, for list l in {0, 1}: the exact HEVC 8-tap
// luma interpolation at mv_l[b, k] on plane r_l[b, k] of the reference
// stack ref_l [R_l, H, W], v_l = (sum_k fy[k] h) >> 6
// (the 14-bit intermediate); then, with want_satd, the SATD (8x8
// Hadamard tiles, (sum|t| + 2) >> 2 per tile) of the source minus
// clamp((v_l + 32) >> 6) for each list and minus
// clamp((v_0 + v_1 + 64) >> 7) for the pair; with want_pred (K = 1),
// v_0 and v_1 themselves. The one-list mode (LISTS = 1, chosen by a null
// ref1) loads one window a candidate, makes one prediction and one SATD
// and writes no bi-average; it keeps one buffer set, so n = 16 and 32
// take half the shared memory of the pair mode.
//
// Bound on an H100: per call the larger of its bytes (the planes, the
// source and the MVs read once, the outputs written once) and its
// operations (chip_smoke.py eval_work) at the FP32 rate. The call with
// predictions moves two [L, n, n] int32 outputs and is bound by bytes;
// the merge call (K = 4, three SATDs a pair) by operations.
//
// Design, against what held the first version back (one thread block
// per source block and list, one thread per 8x8 SATD tile while the
// rest waited, a shared atomic sum, and every prediction written out
// for PyTorch to average and transform again):
// 1. One launch evaluates both lists of K pairs and the bi-average SATD
//    from the same registers; nothing but the final predictions leaves
//    the kernel.
// 2. Every thread works in the SATD. A thread owns one 8-pixel column
//    of an 8x8 tile (n^2 / 8 threads a source block): it makes the
//    column's vertical filter outputs from 15 shared loads, does the
//    column butterflies in registers and the row butterflies with the
//    7 other lanes of its tile (xor 1, 2, 4), then sums |t| the same
//    way. Tile sums add up over the source block's lanes (xor 8, 16) and
//    its warps (a few shared words), in integers: no atomics.
// 3. n = 8 packs 16 source blocks (8 threads each) and n = 16 packs 4
//    (a warp each) into 128-thread blocks. A list's prediction is three
//    phases with a sync between them: the clamped window (a thread keeps
//    one column and all its loads in flight), the horizontal pass
//    (taps from a 32-word shared table filled from luma_tap), the
//    register-blocked vertical pass. At n = 16 and 32 both lists of a
//    pair go through each phase together in two buffer sets (2 syncs a
//    pair, not 4); n = 8 and 64 run the lists one after the other in
//    one set, so that n = 64 keeps 38.8 KB a block (not the 54.7 KB of
//    window, pass and prediction before). __launch_bounds__ caps the
//    registers at 80 (64 at n = 64) for 6 (2) blocks per SM.
// 4. The filter, rounding, averaging and Hadamard run in float32 on the
//    FP32 pipe. Every value is an integer below 2^24 (horizontal pass
//    within [-24, 88] x maxv, vertical sums within 112 x 88 x maxv,
//    Hadamard outputs within 64 x maxv, a tile's sum of |t| within
//    4096 x maxv, all below 2^24 for maxv <= 1023), so float32 is exact
//    and floorf(a * 2^-s) equals a >> s; the wrapper refuses larger
//    maxv. Tile results are converted to int before the block sums.
// The reference planes are read unpadded with every index clamped,
// which equals edge padding. ref0 and ref1 may be the same stack. The
// wrapper checks that every reference index names a plane of its stack;
// the kernel reads the plane's base once a pair (ref + r * H * W), so a
// reference stack costs no more than one plane beyond that load.
#include <cuda_runtime.h>
#include <stdint.h>

#include "me_common.cuh"

namespace {

template <int N, int LISTS>
struct EvalGeom {
    static constexpr int WE = N + 7;           // window side (odd stride)
    static constexpr int HSTR = N + 1;         // horizontal-pass row stride
    static constexpr int STRIPS = N * N / 8;   // 8-pixel tile columns
    static constexpr int TPB = STRIPS;         // threads per source block
    static constexpr int P = TPB < 128 ? 128 / TPB : 1;   // sources a block
    static constexpr int THREADS = P * TPB;
    static constexpr int WARPS = TPB / 32;     // warps per source block
    // buffer sets (window + horizontal pass): 2 runs both lists of a pair
    // through each phase together (half the syncs), 1 one list after the
    // other (half the shared memory: n = 8 packs 16 source blocks, and
    // n = 64 stays at 38.8 KB a block)
    static constexpr int BUFS = LISTS == 1 || N == 8 || N == 64 ? 1 : 2;
    // SATDs a candidate: list 0, list 1 and the bi-average, or list 0
    static constexpr int NS = LISTS == 2 ? 3 : 1;
    // __launch_bounds__ minimum blocks per SM, which caps the registers
    // (at 80 for 128 threads, 64 for 512)
    static constexpr int MIN_BLOCKS = N == 64 ? 2 : 6;
    static constexpr int WIN = WE * WE, HP = WE * HSTR;
    // shared words per source block: the buffer sets, the per-warp
    // partial sums of the NS SATDs
    static constexpr int PER = BUFS * (WIN + HP)
                               + (WARPS > 1 ? NS * WARPS : 0);
    // and the 4 x 8 filter taps, shared by the block
    static constexpr int SMEM_WORDS = P * PER + 32;
    static_assert(TPB % 8 == 0 && THREADS % 32 == 0, "lane groups");
};

// synchronise the threads of one source block (a warp holds whole
// source blocks when they have 32 threads or fewer)
template <int N>
__device__ __forceinline__ void group_sync() {
    if (EvalGeom<N, 2>::TPB <= 32)
        __syncwarp();
    else
        __syncthreads();
}

// floor(a / 2^6) for an integer-valued float |a| < 2^24: exact
__device__ __forceinline__ float shr6(float a) {
    return floorf(a * 0.015625f);
}

// The clamped (N+7)^2 window at (iy, ix) into s_win, coalesced along its
// rows. With N+7 threads or more a thread keeps one column (clamped once)
// and takes every RPP-th row; with fewer (N = 8) it takes the columns t
// and t + TPB. The loops have constant trip counts, so that a thread's
// loads are in flight together.
template <int N>
__device__ __forceinline__ void load_window(const int* __restrict__ ref,
                                            int H, int W, int iy, int ix,
                                            float* s_win, int t) {
    using G = EvalGeom<N, 2>;
    constexpr int WE = G::WE;
    if constexpr (G::TPB >= WE) {
        constexpr int RPP = G::TPB / WE;   // rows a pass
        const int q = t % WE, r0 = t / WE;
        if (r0 < RPP) {
            const int* col = ref + clampi(ix + q, 0, W - 1);
#pragma unroll
            for (int j = 0; j < (WE + RPP - 1) / RPP; ++j) {
                const int r = r0 + j * RPP;
                if (r < WE)
                    s_win[r * WE + q] =
                        (float)col[(size_t)clampi(iy + r, 0, H - 1) * W];
            }
        }
    } else {
#pragma unroll
        for (int c = 0; c < (WE + G::TPB - 1) / G::TPB; ++c) {
            const int q = t + c * G::TPB;
            if (q < WE) {
                const int* col = ref + clampi(ix + q, 0, W - 1);
#pragma unroll
                for (int r = 0; r < WE; ++r)
                    s_win[r * WE + q] =
                        (float)col[(size_t)clampi(iy + r, 0, H - 1) * W];
            }
        }
    }
}

// Horizontal 8-tap pass with taps f over the window: h[row][x] =
// sum_k f[k] win[row][x + k] for the N+7 rows; a thread makes 8 outputs
// of a row from 15 window values.
template <int N>
__device__ __forceinline__ void hpass(const float* s_win, float* s_h,
                                      const float* f, int t) {
    using G = EvalGeom<N, 2>;
    float fk[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) fk[k] = f[k];
    for (int i = t; i < G::WE * (N / 8); i += G::TPB) {
        const int row = i % G::WE, c = (i / G::WE) * 8;
        const float* w = s_win + row * G::WE + c;
        float wv[15];
#pragma unroll
        for (int j = 0; j < 15; ++j) wv[j] = w[j];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float a = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) a = fmaf(fk[k], wv[j + k], a);
            s_h[row * G::HSTR + c + j] = a;
        }
    }
}

// Vertical 8-tap pass with taps f down the thread's column x, rows
// ty..ty+7, from 15 loads: v[i] = (sum_k f[k] h[ty + i + k][x]) >> 6,
// the 14-bit intermediate.
template <int N>
__device__ __forceinline__ void vpass(const float* s_h, const float* f,
                                      int x, int ty, float (&v)[8]) {
    using G = EvalGeom<N, 2>;
    float fk[8], hv[15];
#pragma unroll
    for (int k = 0; k < 8; ++k) fk[k] = f[k];
#pragma unroll
    for (int r = 0; r < 15; ++r) hv[r] = s_h[(ty + r) * G::HSTR + x];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) a = fmaf(fk[k], hv[i + k], a);
        v[i] = shr6(a);
    }
}

// In-register 8-point Walsh-Hadamard butterflies over d[0..7].
__device__ __forceinline__ void wht8(float (&d)[8]) {
#pragma unroll
    for (int h = 1; h < 8; h <<= 1)
#pragma unroll
        for (int i = 0; i < 8; i += 2 * h)
#pragma unroll
            for (int j = i; j < i + h; ++j) {
                const float u = d[j], w = d[j + h];
                d[j] = u + w;
                d[j + h] = u - w;
            }
}

// (sum |H d H| + 2) >> 2 of the thread's 8x8 tile, d being the thread's
// column: column butterflies in registers, row butterflies across the 8
// lanes of the tile (xor 1, 2, 4: a lane adds its partner's value to its
// own or subtracts its own from it, as one exact fmaf(+-1, d, o)); every
// lane of the tile returns the tile's value.
__device__ __forceinline__ int satd_tile(float (&d)[8], int lane) {
    wht8(d);
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) {
        const float sg = (lane & m) ? -1.f : 1.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
            d[i] = fmaf(sg, d[i], __shfl_xor_sync(0xffffffffu, d[i], m));
    }
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) a += fabsf(d[i]);
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    a += __shfl_xor_sync(0xffffffffu, a, 4);
    return ((int)a + 2) >> 2;
}

template <int N, int LISTS>
__global__ void __launch_bounds__(EvalGeom<N, LISTS>::THREADS,
                                  EvalGeom<N, LISTS>::MIN_BLOCKS)
me_eval_kernel(const int* __restrict__ ref0, const int* __restrict__ ref1,
               int H, int W, const int* __restrict__ src,
               const int* __restrict__ mv0, const int* __restrict__ mv1,
               const int* __restrict__ ri0, const int* __restrict__ ri1,
               int K, int L, int cols, int maxv, int* __restrict__ satd_out,
               int* __restrict__ pred_out) {
    using G = EvalGeom<N, LISTS>;
    extern __shared__ float smem[];
    const int g = threadIdx.x / G::TPB, t = threadIdx.x % G::TPB;
    const int lane = threadIdx.x & 31, warp = t >> 5;
    // buffer set l of list l (one set serves both lists when BUFS is 1)
    float* s_win0 = smem + g * G::PER;
    float* s_h0 = s_win0 + G::WIN;
    float* s_win1 = s_win0 + (G::BUFS - 1) * (G::WIN + G::HP);
    float* s_h1 = s_win1 + G::WIN;
    int* s_red = reinterpret_cast<int*>(s_win0 + G::BUFS * (G::WIN + G::HP));
    // the taps as floats, from luma_tap (different phases of the source
    // blocks of a warp fall in different banks)
    float* s_taps = smem + G::P * G::PER;
    if (threadIdx.x < 32)
        s_taps[threadIdx.x] = (float)luma_tap(threadIdx.x >> 3,
                                              threadIdx.x & 7);
    __syncthreads();

    // a tail group past the last source block repeats the last one and
    // writes nothing (it still takes part in every synchronisation)
    const int bidx = blockIdx.x * G::P + g;
    const bool live = bidx < L;
    const int b = live ? bidx : L - 1;
    const int y0 = (b / cols) * N, x0 = (b % cols) * N;
    // the thread's column: x, rows ty..ty+7 (lanes 8j..8j+7 form a tile)
    const int x = t % N, ty = (t / N) * 8;
    const int* srcb = src + (size_t)b * N * N;
    float sv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sv[i] = (float)srcb[(ty + i) * N + x];
    const float maxvf = (float)maxv;
    const size_t plane = (size_t)H * W;

    // Phases: window, sync, horizontal pass, sync, vertical pass. Each
    // sync orders the readers of one buffer before its next writers: the
    // window's before the next window (second sync), the pass's before
    // the next pass (first sync of the next phase run).
    for (int k = 0; k < K; ++k) {
        const size_t m = ((size_t)b * K + k) * 2;
        const int ax = mv0[m], ay = mv0[m + 1];
        const int* pl0 = ref0 + ri0[m >> 1] * plane;
        float v0[8], v1[8];
        if (LISTS == 2 && G::BUFS == 2) {
            const int bx = mv1[m], by = mv1[m + 1];
            const int* pl1 = ref1 + ri1[m >> 1] * plane;
            load_window<N>(pl0, H, W, y0 + (ay >> 2) - 3,
                           x0 + (ax >> 2) - 3, s_win0, t);
            load_window<N>(pl1, H, W, y0 + (by >> 2) - 3,
                           x0 + (bx >> 2) - 3, s_win1, t);
            group_sync<N>();
            hpass<N>(s_win0, s_h0, s_taps + (ax & 3) * 8, t);
            hpass<N>(s_win1, s_h1, s_taps + (bx & 3) * 8, t);
            group_sync<N>();
            vpass<N>(s_h0, s_taps + (ay & 3) * 8, x, ty, v0);
            vpass<N>(s_h1, s_taps + (by & 3) * 8, x, ty, v1);
        } else {
            load_window<N>(pl0, H, W, y0 + (ay >> 2) - 3,
                           x0 + (ax >> 2) - 3, s_win0, t);
            group_sync<N>();
            hpass<N>(s_win0, s_h0, s_taps + (ax & 3) * 8, t);
            group_sync<N>();
            vpass<N>(s_h0, s_taps + (ay & 3) * 8, x, ty, v0);
            if (LISTS == 2) {
                const int bx = mv1[m], by = mv1[m + 1];
                const int* pl1 = ref1 + ri1[m >> 1] * plane;
                load_window<N>(pl1, H, W, y0 + (by >> 2) - 3,
                               x0 + (bx >> 2) - 3, s_win1, t);
                group_sync<N>();
                hpass<N>(s_win1, s_h1, s_taps + (bx & 3) * 8, t);
                group_sync<N>();
                vpass<N>(s_h1, s_taps + (by & 3) * 8, x, ty, v1);
            }
        }
        if (pred_out != nullptr && live) {
            int* p0 = pred_out + (size_t)b * N * N;
            int* p1 = p0 + (size_t)L * N * N;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                p0[(ty + i) * N + x] = (int)v0[i];
                if (LISTS == 2) p1[(ty + i) * N + x] = (int)v1[i];
            }
        }
        if (satd_out == nullptr) continue;
        int s[G::NS];
#pragma unroll
        for (int c = 0; c < G::NS; ++c) {
            float d[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float p = c == 0 ? shr6(v0[i] + 32.f)
                              : c == 1 ? shr6(v1[i] + 32.f)
                                       : floorf((v0[i] + v1[i] + 64.f)
                                                * 0.0078125f);
                d[i] = sv[i] - fminf(fmaxf(p, 0.f), maxvf);
            }
            s[c] = satd_tile(d, lane);
            // add up the source block's tiles within the warp
            if (G::TPB >= 16) s[c] += __shfl_xor_sync(0xffffffffu, s[c], 8);
            if (G::TPB >= 32) s[c] += __shfl_xor_sync(0xffffffffu, s[c], 16);
        }
        if (G::WARPS > 1) {
            if (lane < G::NS)
                s_red[warp * G::NS + lane] = lane == 0 ? s[0]
                                           : lane == 1 ? s[1 % G::NS]
                                                       : s[2 % G::NS];
            group_sync<N>();
            if (t < G::NS) {
                int a = 0;
#pragma unroll
                for (int w = 0; w < G::WARPS; ++w) a += s_red[w * G::NS + t];
                if (live) satd_out[((size_t)t * L + b) * K + k] = a;
            }
        } else if (t == 0 && live) {
#pragma unroll
            for (int c = 0; c < G::NS; ++c)
                satd_out[((size_t)c * L + b) * K + k] = s[c];
        }
    }
}

template <int N, int LISTS>
cudaError_t prepare(size_t* smem) {
    *smem = sizeof(float) * EvalGeom<N, LISTS>::SMEM_WORDS;
    return cudaFuncSetAttribute(me_eval_kernel<N, LISTS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
}

template <int N, int LISTS>
cudaError_t launch(const int* ref0, const int* ref1, int H, int W,
                   const int* src, const int* mv0, const int* mv1,
                   const int* ri0, const int* ri1, int K, int L, int cols,
                   int maxv, int* satd, int* pred, cudaStream_t stream) {
    using G = EvalGeom<N, LISTS>;
    size_t smem;
    cudaError_t e = prepare<N, LISTS>(&smem);
    if (e != cudaSuccess) return e;
    if (L > 0 && K > 0)
        me_eval_kernel<N, LISTS><<<(L + G::P - 1) / G::P, G::THREADS, smem,
                                   stream>>>(ref0, ref1, H, W, src, mv0,
                                             mv1, ri0, ri1, K, L, cols,
                                             maxv, satd, pred);
    return cudaGetLastError();
}

template <int N, int LISTS>
cudaError_t info(int* out) {
    using G = EvalGeom<N, LISTS>;
    size_t smem;
    cudaError_t e = prepare<N, LISTS>(&smem);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, me_eval_kernel<N, LISTS>, G::THREADS, smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, me_eval_kernel<N, LISTS>);
    if (e != cudaSuccess) return e;
    out[0] = blocks;
    out[1] = G::THREADS;
    out[2] = G::P;
    out[3] = (int)smem;
    out[4] = a.numRegs;
    out[5] = (int)a.localSizeBytes;
    return cudaSuccess;
}

template <int LISTS>
cudaError_t info_n(int n, int* out) {
    switch (n) {
        case 8: return info<8, LISTS>(out);
        case 16: return info<16, LISTS>(out);
        case 32: return info<32, LISTS>(out);
        case 64: return info<64, LISTS>(out);
        default: return cudaErrorInvalidValue;
    }
}

template <int LISTS>
cudaError_t launch_n(const int* f0, const int* f1, int H, int W,
                     const int* s, const int* m0, const int* m1,
                     const int* i0, const int* i1, int K, int L, int n,
                     int cols, int maxv, int* sd, int* p, cudaStream_t st) {
    switch (n) {
        case 8: return launch<8, LISTS>(f0, f1, H, W, s, m0, m1, i0, i1, K, L, cols, maxv, sd, p, st);
        case 16: return launch<16, LISTS>(f0, f1, H, W, s, m0, m1, i0, i1, K, L, cols, maxv, sd, p, st);
        case 32: return launch<32, LISTS>(f0, f1, H, W, s, m0, m1, i0, i1, K, L, cols, maxv, sd, p, st);
        case 64: return launch<64, LISTS>(f0, f1, H, W, s, m0, m1, i0, i1, K, L, cols, maxv, sd, p, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Launch geometry of the size-n kernel with `lists` lists (1 or 2):
// out[0..5] = blocks per SM the launch achieves
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads per block,
// source blocks per block, dynamic shared bytes per block, registers per
// thread, local (spill) bytes per thread.
extern "C" int kvz_me_eval_info(int n, int lists, int* out) {
    if (lists == 1) return info_n<1>(n, out);
    if (lists == 2) return info_n<2>(n, out);
    return cudaErrorInvalidValue;
}

// ref0, ref1: int32 stacks [R, H, W]; r0, r1: int32 [L, K] plane
// indices, each below its stack's R (the caller checks); satd: int32
// [3, L, K] (list 0, list 1, bi) or null; pred: int32 [2, L, n, n] (v_0,
// v_1 of pair 0; K must be 1) or null. A null ref1 selects the one-list
// mode: mv1 and r1 are not read, satd is [1, L, K] and pred [1, L, n, n].
extern "C" int kvz_me_eval(const void* ref0, const void* ref1, int H, int W,
                           const void* src, const void* mv0, const void* mv1,
                           const void* r0, const void* r1, int K, int L,
                           int n, int cols, int maxv, void* satd, void* pred,
                           void* stream) {
    const int* f0 = static_cast<const int*>(ref0);
    const int* f1 = static_cast<const int*>(ref1);
    const int* s = static_cast<const int*>(src);
    const int* m0 = static_cast<const int*>(mv0);
    const int* m1 = static_cast<const int*>(mv1);
    const int* i0 = static_cast<const int*>(r0);
    const int* i1 = static_cast<const int*>(r1);
    int* sd = static_cast<int*>(satd);
    int* p = static_cast<int*>(pred);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (f1 == nullptr)
        return launch_n<1>(f0, f1, H, W, s, m0, m1, i0, i1, K, L, n, cols,
                           maxv, sd, p, st);
    return launch_n<2>(f0, f1, H, W, s, m0, m1, i0, i1, K, L, n, cols, maxv,
                       sd, p, st);
}
