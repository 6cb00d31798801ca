// Grouped <IL, FL> wire encoder for Hopper (sm_90a).
//
// Replaces the TPU kernel `_group_kernel` of src/repro/kernels/dps_quant.py
// (entry `dps_quant_group_wire_pallas`): a group-aligned flat buffer of
// T tiles of `quantum` elements; tile t is rounded onto the grid of row
// tile_group[t] of a [G, 2] <IL, FL> table and written as int8 grid integers
// saturated to [-128, 127]; seven statistics per group come out beside it.
//
// Bound on this card: bytes.  Per element the kernel reads 4 B of x (2 B in
// bf16), 4 B of mask and, under stochastic rounding, 4 B of random bits, and
// writes 1 B; the arithmetic is a dozen fp32 operations.  The design moves
// each byte once: one block per tile, 16-byte loads where the quantum
// divides by four (a scalar loop otherwise, so any quantum >= 1 is taken),
// the table row read by the block itself.
//
// The TPU body carries its statistics in one accumulator across a sequential
// grid.  Blocks here run in no order, so each block reduces its tile to seven
// numbers in a fixed order (lane, then warp), writes them to partials[T, 7],
// and a second kernel folds the tiles of each group, again in a fixed order.
// No float atomics: the same input gives the same bits on every run.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int N_STATS = 7;       // count nonzero overflow abs_err rel_err abs_sum max_abs
constexpr int ENC_THREADS = 256;
constexpr int RED_THREADS = 128;

struct Grid {
    float scale, inv_scale, qmin, qmax;
};

__device__ __forceinline__ Grid make_grid(int il, int fl) {
    Grid g;
    g.scale = exp2i(fl);
    g.inv_scale = exp2i(-fl);
    const float span = exp2i(il - 1 + fl);
    g.qmax = span - 1.0f;
    g.qmin = -span;
    return g;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load4(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    // a bf16 is the upper half of the fp32 with the same value
    o[0] = __uint_as_float(v.x << 16);
    o[1] = __uint_as_float(v.x & 0xffff0000u);
    o[2] = __uint_as_float(v.y << 16);
    o[3] = __uint_as_float(v.y & 0xffff0000u);
}

template <bool STOCH, bool STATS>
__device__ __forceinline__ signed char encode_one(float x, uint32_t bits, float m,
                                                  const Grid& g, float* acc) {
    const float y = x * g.scale;
    const float yc = fminf(fmaxf(y, g.qmin), g.qmax);
    float q;
    if (STOCH) {
        // top 24 bits -> uniform in [0, 1) on the 2^-24 grid
        const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
        q = floorf(yc + u);
    } else {
        q = floorf(yc + 0.5f);
    }
    q = fminf(fmaxf(q, g.qmin), g.qmax);
    const float sat = fminf(fmaxf(q, -128.0f), 127.0f);
    if (STATS) {
        const bool over = (y > g.qmax) || (y < g.qmin) || (q != sat);
        const float x_ref = yc * g.inv_scale;       // range-clipped value
        const float dec = sat * g.inv_scale;        // what a reader decodes
        const float abs_err = fabsf(dec - x_ref) * m;
        const float abs_ref = fabsf(x_ref) * m;
        const bool nz = abs_ref > 0.0f;
        acc[0] += m;
        acc[1] += nz ? 1.0f : 0.0f;
        acc[2] += over ? m : 0.0f;
        acc[3] += abs_err;
        acc[4] += nz ? abs_err / abs_ref : 0.0f;    // IEEE division
        acc[5] += abs_ref;
        acc[6] = fmaxf(acc[6], fabsf(x) * m);
    }
    return static_cast<signed char>(static_cast<int>(sat * m));
}

// Seven per-thread numbers -> seven per-block numbers in thread 0: six sums
// and one max, lanes first, then warps in index order.
template <int THREADS>
__device__ __forceinline__ void block_reduce_stats(float* acc) {
    __shared__ float part[THREADS / 32][N_STATS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < N_STATS - 1; ++k) acc[k] = warp_sum_down(acc[k]);
    acc[N_STATS - 1] = warp_max_down(acc[N_STATS - 1]);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < N_STATS; ++k) part[warp][k] = acc[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < THREADS / 32; ++w) {
#pragma unroll
            for (int k = 0; k < N_STATS - 1; ++k) acc[k] += part[w][k];
            acc[N_STATS - 1] = fmaxf(acc[N_STATS - 1], part[w][N_STATS - 1]);
        }
    }
}

template <typename XT, bool STOCH, bool STATS, bool VEC>
__global__ void __launch_bounds__(ENC_THREADS)
group_wire_encode_kernel(const XT* __restrict__ x, const int* __restrict__ fmt_tab,
                         const int* __restrict__ tile_group,
                         const uint32_t* __restrict__ bits,
                         const float* __restrict__ mask,
                         signed char* __restrict__ wire,
                         float* __restrict__ partials, long long quantum) {
    const long long t = blockIdx.x;
    const int grp = tile_group[t];
    const Grid g = make_grid(fmt_tab[2 * grp], fmt_tab[2 * grp + 1]);
    const long long base = t * quantum;
    float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

    const long long nvec = VEC ? quantum / 4 : 0;
    for (long long i = threadIdx.x; i < nvec; i += ENC_THREADS) {
        const long long e = base + 4 * i;
        float xv[4];
        load4(x + e, xv);
        uint32_t bv[4] = {0u, 0u, 0u, 0u};
        if (STOCH) {
            const uint4 b = *reinterpret_cast<const uint4*>(bits + e);
            bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
        }
        float mv[4] = {1.0f, 1.0f, 1.0f, 1.0f};
        if (mask != nullptr) load4(mask + e, mv);
        char4 w;
        w.x = encode_one<STOCH, STATS>(xv[0], bv[0], mv[0], g, acc);
        w.y = encode_one<STOCH, STATS>(xv[1], bv[1], mv[1], g, acc);
        w.z = encode_one<STOCH, STATS>(xv[2], bv[2], mv[2], g, acc);
        w.w = encode_one<STOCH, STATS>(xv[3], bv[3], mv[3], g, acc);
        *reinterpret_cast<char4*>(wire + e) = w;
    }
    // scalar tail: everything when 16-byte loads do not divide the quantum
    for (long long i = 4 * nvec + threadIdx.x; i < quantum; i += ENC_THREADS) {
        const long long e = base + i;
        const uint32_t b = STOCH ? bits[e] : 0u;
        const float m = mask != nullptr ? mask[e] : 1.0f;
        wire[e] = encode_one<STOCH, STATS>(to_f32(x[e]), b, m, g, acc);
    }

    if (STATS) {
        block_reduce_stats<ENC_THREADS>(acc);
        if (threadIdx.x == 0) {
#pragma unroll
            for (int k = 0; k < N_STATS; ++k) partials[t * N_STATS + k] = acc[k];
        }
    }
}

// Second stage: block g folds partials[t] of every tile with
// tile_group[t] == g into stats[g] (sums add, the max column maxes; a group
// without tiles gets zeros).
__global__ void __launch_bounds__(RED_THREADS)
group_stats_reduce_kernel(const float* __restrict__ partials,
                          const int* __restrict__ tile_group,
                          float* __restrict__ stats, long long tiles) {
    const int grp = blockIdx.x;
    float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (long long t = threadIdx.x; t < tiles; t += RED_THREADS) {
        if (tile_group[t] != grp) continue;
#pragma unroll
        for (int k = 0; k < N_STATS - 1; ++k) acc[k] += partials[t * N_STATS + k];
        acc[N_STATS - 1] = fmaxf(acc[N_STATS - 1], partials[t * N_STATS + N_STATS - 1]);
    }
    block_reduce_stats<RED_THREADS>(acc);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < N_STATS; ++k) stats[grp * N_STATS + k] = acc[k];
    }
}

template <typename XT, bool STOCH, bool STATS>
void launch_encode(bool vec, unsigned tiles, cudaStream_t s, const XT* x,
                   const int* fmt_tab, const int* tile_group, const uint32_t* bits,
                   const float* mask, signed char* wire, float* partials,
                   long long quantum) {
    if (vec)
        group_wire_encode_kernel<XT, STOCH, STATS, true><<<tiles, ENC_THREADS, 0, s>>>(
            x, fmt_tab, tile_group, bits, mask, wire, partials, quantum);
    else
        group_wire_encode_kernel<XT, STOCH, STATS, false><<<tiles, ENC_THREADS, 0, s>>>(
            x, fmt_tab, tile_group, bits, mask, wire, partials, quantum);
}

template <typename XT>
void dispatch_encode(bool stoch, bool stats, bool vec, unsigned tiles, cudaStream_t s,
                     const XT* x, const int* fmt_tab, const int* tile_group,
                     const uint32_t* bits, const float* mask, signed char* wire,
                     float* partials, long long quantum) {
    if (stoch && stats)
        launch_encode<XT, true, true>(vec, tiles, s, x, fmt_tab, tile_group, bits, mask, wire, partials, quantum);
    else if (stoch)
        launch_encode<XT, true, false>(vec, tiles, s, x, fmt_tab, tile_group, bits, mask, wire, partials, quantum);
    else if (stats)
        launch_encode<XT, false, true>(vec, tiles, s, x, fmt_tab, tile_group, bits, mask, wire, partials, quantum);
    else
        launch_encode<XT, false, false>(vec, tiles, s, x, fmt_tab, tile_group, bits, mask, wire, partials, quantum);
}

}  // namespace

// Plain C interface.  All pointers are device pointers.  `bits` null means
// round to nearest; `mask` null means every element counts; `partials` and
// `stats` null means no statistics.  `vec` says the caller checked that the
// quantum divides by four and the buffers are 16-byte aligned.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int dps_group_wire_encode(const void* x, int x_is_bf16, const void* fmt_tab,
                                     const void* tile_group, const void* bits,
                                     const void* mask, void* wire, void* partials,
                                     void* stats, long long tiles, long long quantum,
                                     int groups, int vec, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool emit = partials != nullptr && stats != nullptr;
    if (tiles > 0 && quantum > 0) {
        const unsigned nt = static_cast<unsigned>(tiles);
        if (x_is_bf16)
            dispatch_encode<__nv_bfloat16>(
                bits != nullptr, emit, vec != 0, nt, s,
                static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(fmt_tab),
                static_cast<const int*>(tile_group), static_cast<const uint32_t*>(bits),
                static_cast<const float*>(mask), static_cast<signed char*>(wire),
                static_cast<float*>(partials), quantum);
        else
            dispatch_encode<float>(
                bits != nullptr, emit, vec != 0, nt, s, static_cast<const float*>(x),
                static_cast<const int*>(fmt_tab), static_cast<const int*>(tile_group),
                static_cast<const uint32_t*>(bits), static_cast<const float*>(mask),
                static_cast<signed char*>(wire), static_cast<float*>(partials), quantum);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (emit && groups > 0) {
        group_stats_reduce_kernel<<<static_cast<unsigned>(groups), RED_THREADS, 0, s>>>(
            static_cast<const float*>(partials), static_cast<const int*>(tile_group),
            static_cast<float*>(stats), tiles);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
