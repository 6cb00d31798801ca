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
//
// The same file holds the quantizer of the training path (K1 and K1b below):
// it replaces `_kernel` with emit_wire=False (entry `dps_quant_pallas`,
// pallas_call at src/repro/kernels/dps_quant.py:288), in both of its bit
// sources: a uint32 bits operand (K1) and random bits made in the kernel
// (K1b, the TPU's use_onchip_prng=True).  Per element: y = x*2^FL, clip to
// the <IL, FL> range, floor(y + u) or floor(y + 0.5), clip, q = k*2^-FL in
// x's dtype, plus the seven statistics of fixed_point.quantize.
//
// Bound on this card: bytes.  K1 reads x (4 B fp32, 2 B bf16) and 4 B of
// bits and writes q; K1b draws the bits with Philox4x32-10 in registers
// (about 40 integer operations per 4 elements, far below the rate at which
// the bytes arrive), so it moves 8 B per fp32 element instead of 12.  The
// design: a 1-D grid-stride pass over the flat tensor in groups of four
// elements (16-byte loads of fp32 x and bits when the pointers allow, a
// scalar tail by predicate, so no pad or mask copies), <IL, FL> read from
// device memory by every block (the controller moves them on the device
// every step), per-block statistics partials in double reduced lane -> warp
// -> block, and a second one-block launch that folds the partials in block
// order.  Counts are integers until the final cast, so `count`, `nonzero`
// and `overflow` stay exact past 2^24 elements.

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

// ---------------------------------------------------------------------------
// K1 / K1b: the emulation quantizer of the training path.
// ---------------------------------------------------------------------------

constexpr int Q_THREADS = 256;

// Clamp that lets NaN through, as torch.clamp and jnp.clip do.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
    return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// Max that lets NaN through, as torch.max and jnp.max do.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ void store4(float* p, const float* q) {
    *reinterpret_cast<float4*>(p) = make_float4(q[0], q[1], q[2], q[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* q) {
    // round to nearest even, as a float32 -> bfloat16 cast does in PyTorch
    const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(q[0]));
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(q[1]));
    const uint32_t c = __bfloat16_as_ushort(__float2bfloat16_rn(q[2]));
    const uint32_t d = __bfloat16_as_ushort(__float2bfloat16_rn(q[3]));
    *reinterpret_cast<uint2*>(p) = make_uint2(a | (b << 16), c | (d << 16));
}

__device__ __forceinline__ void store1(float* p, float q) { *p = q; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float q) {
    *p = __float2bfloat16_rn(q);
}

// Per-thread statistics: integer counts, double sums, a float max.
struct QAcc {
    unsigned int nz = 0u, over = 0u;
    double abs_err = 0.0, rel = 0.0, abs_ref = 0.0;
    float mx = 0.0f;
};

// bits source: 0 = round to nearest, 1 = bits operand, 2 = Philox in registers
template <int SRC, bool STATS>
__device__ __forceinline__ float quant_one(float x, uint32_t bits, const Grid& g,
                                           QAcc& acc) {
    const float y = x * g.scale;
    const float yc = clamp_nan(y, g.qmin, g.qmax);
    float k;
    if (SRC == 0) {
        k = floorf(yc + 0.5f);
    } else {
        // top 24 bits, logical shift -> uniform in [0, 1) on the 2^-24 grid
        k = floorf(yc + static_cast<float>(bits >> 8) * (1.0f / 16777216.0f));
    }
    k = clamp_nan(k, g.qmin, g.qmax);
    const float q = k * g.inv_scale;
    if (STATS) {
        const float x_ref = yc * g.inv_scale;      // range-clipped value
        const float abs_err = fabsf(q - x_ref);
        const float abs_ref = fabsf(x_ref);
        const bool nz = abs_ref > 0.0f;
        acc.nz += nz ? 1u : 0u;
        acc.over += ((y > g.qmax) || (y < g.qmin)) ? 1u : 0u;
        acc.abs_err += abs_err;
        acc.rel += nz ? abs_err / abs_ref : 0.0f;  // IEEE division
        acc.abs_ref += abs_ref;
        acc.mx = max_nan(acc.mx, fabsf(x));
    }
    return q;
}

// A partial row: nonzero overflow abs_err rel_err abs_sum (double; the counts
// are exact in a double) and max_abs.
constexpr int Q_PART = 6;

struct QRow {
    double v[Q_PART - 1];
    float mx;
};

// Thread rows -> the block's row in thread 0: lanes, then warps in index order.
__device__ __forceinline__ void block_reduce_row(QRow& r) {
    __shared__ QRow part[Q_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < Q_PART - 1; ++k) r.v[k] += __shfl_down_sync(0xffffffffu, r.v[k], o);
        r.mx = max_nan(r.mx, __shfl_down_sync(0xffffffffu, r.mx, o));
    }
    if (lane == 0) part[warp] = r;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < Q_THREADS / 32; ++w) {
#pragma unroll
            for (int k = 0; k < Q_PART - 1; ++k) r.v[k] += part[w].v[k];
            r.mx = max_nan(r.mx, part[w].mx);
        }
    }
}

template <typename XT, int SRC, bool STATS, bool VEC>
__global__ void __launch_bounds__(Q_THREADS)
quantize_kernel(const XT* __restrict__ x, long long n, const int* __restrict__ il,
                const int* __restrict__ fl, const uint32_t* __restrict__ bits,
                unsigned long long seed, XT* __restrict__ q,
                double* __restrict__ partials) {
    const Grid g = make_grid(*il, *fl);
    QAcc acc;
    const long long stride = static_cast<long long>(gridDim.x) * Q_THREADS;
    const long long t0 = static_cast<long long>(blockIdx.x) * Q_THREADS + threadIdx.x;
    const long long groups = n / 4;       // whole groups of four elements

    if (VEC) {
        for (long long gi = t0; gi < groups; gi += stride) {
            const long long e = 4 * gi;
            float xv[4], qv[4];
            load4(x + e, xv);
            uint32_t bv[4] = {0u, 0u, 0u, 0u};
            if (SRC == 1) {
                const uint4 b = *reinterpret_cast<const uint4*>(bits + e);
                bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
            } else if (SRC == 2) {
                const Philox4 r = philox4x32_10(static_cast<uint64_t>(gi), seed);
                bv[0] = r.v[0]; bv[1] = r.v[1]; bv[2] = r.v[2]; bv[3] = r.v[3];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) qv[j] = quant_one<SRC, STATS>(xv[j], bv[j], g, acc);
            store4(q + e, qv);
        }
    }
    // scalar path: everything when 16-byte access is not possible, else the
    // ragged tail of fewer than four elements
    for (long long e = (VEC ? 4 * groups : 0) + t0; e < n; e += stride) {
        uint32_t b = 0u;
        if (SRC == 1) b = bits[e];
        if (SRC == 2) b = philox4x32_10(static_cast<uint64_t>(e >> 2), seed).v[e & 3];
        store1(q + e, quant_one<SRC, STATS>(to_f32(x[e]), b, g, acc));
    }

    if (STATS) {
        QRow r;
        r.v[0] = acc.nz; r.v[1] = acc.over; r.v[2] = acc.abs_err; r.v[3] = acc.rel;
        r.v[4] = acc.abs_ref; r.mx = acc.mx;
        block_reduce_row(r);
        if (threadIdx.x == 0) {
            double* row = partials + static_cast<long long>(blockIdx.x) * Q_PART;
#pragma unroll
            for (int k = 0; k < Q_PART - 1; ++k) row[k] = r.v[k];
            row[Q_PART - 1] = r.mx;
        }
    }
}

// Second stage: one block folds the per-block partials in block order and
// writes the seven float32 statistics (count nonzero overflow abs_err_sum
// rel_err_sum abs_sum max_abs).
__global__ void __launch_bounds__(Q_THREADS)
quantize_stats_kernel(const double* __restrict__ partials, int nblocks, long long n,
                      float* __restrict__ stats) {
    QRow r = {{0.0, 0.0, 0.0, 0.0, 0.0}, 0.0f};
    for (int b = threadIdx.x; b < nblocks; b += Q_THREADS) {
        const double* p = partials + static_cast<long long>(b) * Q_PART;
#pragma unroll
        for (int k = 0; k < Q_PART - 1; ++k) r.v[k] += p[k];
        r.mx = max_nan(r.mx, static_cast<float>(p[Q_PART - 1]));
    }
    block_reduce_row(r);
    if (threadIdx.x == 0) {
        stats[0] = static_cast<float>(n);
#pragma unroll
        for (int k = 0; k < Q_PART - 1; ++k) stats[1 + k] = static_cast<float>(r.v[k]);
        stats[6] = r.mx;
    }
}

template <typename XT, int SRC, bool STATS>
void launch_quantize(bool vec, int nblocks, cudaStream_t s, const XT* x, long long n,
                     const int* il, const int* fl, const uint32_t* bits,
                     unsigned long long seed, XT* q, double* partials) {
    if (vec)
        quantize_kernel<XT, SRC, STATS, true><<<nblocks, Q_THREADS, 0, s>>>(
            x, n, il, fl, bits, seed, q, partials);
    else
        quantize_kernel<XT, SRC, STATS, false><<<nblocks, Q_THREADS, 0, s>>>(
            x, n, il, fl, bits, seed, q, partials);
}

template <typename XT, int SRC>
void dispatch_quantize_stats(bool stats, bool vec, int nblocks, cudaStream_t s,
                             const XT* x, long long n, const int* il, const int* fl,
                             const uint32_t* bits, unsigned long long seed, XT* q,
                             double* partials) {
    if (stats)
        launch_quantize<XT, SRC, true>(vec, nblocks, s, x, n, il, fl, bits, seed, q, partials);
    else
        launch_quantize<XT, SRC, false>(vec, nblocks, s, x, n, il, fl, bits, seed, q, partials);
}

template <typename XT>
void dispatch_quantize(int src, bool stats, bool vec, int nblocks, cudaStream_t s,
                       const XT* x, long long n, const int* il, const int* fl,
                       const uint32_t* bits, unsigned long long seed, XT* q,
                       double* partials) {
    if (src == 0)
        dispatch_quantize_stats<XT, 0>(stats, vec, nblocks, s, x, n, il, fl, bits, seed, q, partials);
    else if (src == 1)
        dispatch_quantize_stats<XT, 1>(stats, vec, nblocks, s, x, n, il, fl, bits, seed, q, partials);
    else
        dispatch_quantize_stats<XT, 2>(stats, vec, nblocks, s, x, n, il, fl, bits, seed, q, partials);
}

}  // namespace

// K1 / K1b.  All pointers are device pointers; `il`/`fl` point at one int32
// each.  `src`: 0 = round to nearest, 1 = stochastic with the `bits` operand
// (K1), 2 = stochastic with Philox bits keyed on `seed` (K1b).  `partials`
// (double [nblocks, 6]) and `stats` (float [7]) null means no statistics.
// `vec` says the caller checked 16-byte alignment of x, q and bits.  The
// caller sizes the grid (`nblocks`) as a function of n alone, so the
// statistics' summation order, too, depends on n alone.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int dps_quantize(const void* x, int x_is_bf16, long long n, const void* il,
                            const void* fl, const void* bits, int src,
                            unsigned long long seed, void* q, void* partials,
                            void* stats, int nblocks, int vec, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool emit = partials != nullptr && stats != nullptr;
    if (src < 0 || src > 2 || nblocks < 1 || (src == 1 && bits == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
        if (x_is_bf16)
            dispatch_quantize<__nv_bfloat16>(
                src, emit, vec != 0, nblocks, s, static_cast<const __nv_bfloat16*>(x), n,
                static_cast<const int*>(il), static_cast<const int*>(fl),
                static_cast<const uint32_t*>(bits), seed,
                static_cast<__nv_bfloat16*>(q), static_cast<double*>(partials));
        else
            dispatch_quantize<float>(
                src, emit, vec != 0, nblocks, s, static_cast<const float*>(x), n,
                static_cast<const int*>(il), static_cast<const int*>(fl),
                static_cast<const uint32_t*>(bits), seed, static_cast<float*>(q),
                static_cast<double*>(partials));
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (emit) {
        quantize_stats_kernel<<<1, Q_THREADS, 0, s>>>(
            static_cast<const double*>(partials), n > 0 ? nblocks : 0, n,
            static_cast<float*>(stats));
    }
    return static_cast<int>(cudaGetLastError());
}

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
