// The DPS quantizer kernels for Hopper (sm_90a): K1/K1b/K2/K2b, K3/K3b, K4.
//
// K1 / K1b / K2 / K2b (`quantize_kernel`) replace `_kernel` of
// src/repro/kernels/dps_quant.py (pallas_call at :288) in both of its
// flavours: emit_wire=False (entry `dps_quant_pallas`, q in x's dtype) and
// emit_wire=True (entry `dps_quant_wire_pallas`, the int8 wire payload), each
// with its bit sources: round to nearest, a uint32 bits operand (K1, K2) and
// random bits made in the kernel (K1b, K2b: the TPU's use_onchip_prng=True).
// Per element: y = x*2^FL, clip to the <IL, FL> range, floor(y + u) or
// floor(y + 0.5), clip; K1 writes q = k*2^-FL in x's dtype, K2 writes
// sat = clip(k, -128, 127) as int8, counts k != sat as overflow and measures
// the error against the decoded sat*2^-FL.  The seven statistics of
// fixed_point.quantize / wire_quantize come out beside it.
//
// Bound on this card: bytes without statistics, issue with them.  K1 reads x
// (4 B fp32, 2 B bf16) and 4 B of bits and writes q; K2b moves 4 B in + 1 B
// out per fp32 element, K2 with an operand 4 B more.  Philox4x32-10 (K1b,
// K2b) costs about 40 integer operations per 4 elements, the statistics about
// 25 instructions an element (clips, the error terms, an IEEE division, three
// sums, two counts, the max): with them the kernel issues about 55
// instructions an element, and at 704 M elements that, not the bytes, sets
// the time.  The design: a 1-D grid-stride pass over the flat tensor in
// groups of four elements (16-byte loads of fp32 x and bits and a 4- or
// 16-byte store when the pointers allow, a scalar tail by predicate, so no
// pad or mask copies), the grid four blocks an SM (at most 64 registers a
// thread), one wave.  Without statistics a thread takes four groups an
// iteration, all four loads issued before the first is used and the Philox
// words drawn while they are out; with statistics one group (more spills
// the 64 registers and is slower, measured).  The float terms of the sums
// add in a fixed pairwise tree over the group and go to double once a group;
// counts are integers; the grid's span <= 2^22 floors by two adds, NaN-
// propagating clips are one instruction each, the int8 byte comes from an add
// (no quarter-rate conversions).  <IL, FL> are read from device memory by
// every block (the controller moves them on the device every step);
// per-block statistics partials (integer counts, double sums) are reduced
// lane -> warp -> block, and a second one-block launch folds the partials in
// block order.  The output may be a slice of a larger buffer (the wire path
// writes each leaf straight into its slot of a rank's int8 payload).  On an
// H100 at 700 W (kernel_ab.py, both designs in one run) K2b on the
// 704,643,072-value w_in gradient takes 1.89 ms with statistics (1.245
// without; the bound is 1.05) against 2.337 (1.496) before this design; K1b
// on w_in 2.08 against 2.25 ms; at LeNet's 400,000-value fc1 both designs
// take 0.0105-0.0107 ms with statistics, and without 0.0076 against 0.0072.
//
// K3 / K3b (`group_wire_encode_kernel`) replace `_group_kernel` (entry
// `dps_quant_group_wire_pallas`, pallas_call at :482): a group-aligned flat
// buffer of T tiles of `quantum` elements; tile t is rounded onto the grid
// of row tile_group[t] of a [G, 2] <IL, FL> table and written as int8 grid
// integers saturated to [-128, 127]; seven statistics per group come out
// beside it.  K3b is the use_onchip_prng=True branch (:387-389), keyed here
// per group rather than per tile: group g draws the Philox stream of
// fold_seed(seed, group_base + g) and element e of the group takes word e%4
// of counter e/4, where e counts from the group's start in the aligned
// layout.  So a wire leg's bits depend on (seed, group, element) and not on
// which rank owns the chunk or on the layout's quantum.
//
// Bound on this card: bytes.  Per element K3 reads 4 B of x (2 B in bf16), 4 B
// of mask when masked and 4 B of bits with an operand, and writes 1 B; K3b on
// a wire chunk moves 5 B per element.  One block per tile, 16-byte loads where
// the quantum divides by four (a scalar loop otherwise, so any quantum >= 1 is
// taken), the table row read by the block itself.  The TPU body carries its
// statistics in one accumulator across a sequential grid; here each block
// reduces its tile to one partial row (integer counts, double sums), and a
// second kernel folds the tiles of each group in a fixed order, so counts stay
// exact past 2^24 elements and the same input gives the same bits every run.
//
// K4 (`wire_reduce_tma_kernel`, `wire_reduce_stride_kernel`) replaces
// `_wire_reduce_kernel` (entry `dps_wire_reduce_pallas`, pallas_call at
// :544): the receive leg, int8 [n, chunk] (rows `row_stride` elements apart)
// -> fp32 [chunk] mean over the n rows, each tile decoded with the FL of its
// table row.  Bound on this card: bytes, n*chunk in and 4*chunk out (8 B an
// element at n = 4); nothing in it is compute.  What held the grid-stride
// body it had at 58 % of that bound (46 % on a bucket's chunk) was bytes in
// flight: one 16-byte load a thread outstanding, the rank loop not unrolled,
// 1,024 threads an SM, about 16 KB an SM against the ~20 KB that 3.35 TB/s
// at ~0.7 us needs, and a division and two dependent table loads before each
// 16 elements.  The TMA body: a persistent grid (two blocks an SM, fewer when
// there are fewer items) of 256 consumer threads and one producer thread a
// block, and a ring of 4 stages in dynamic shared memory, each the n rows of one item of
// `span` elements (16 KB at n = 4: span 4096).  Items are spans inside one
// tile, so an item has one format; block b takes items b, b + grid, ...  The
// producer looks the item's 2^-FL up once (the loads issued before it waits
// for the stage), writes it beside the stage, and issues one bulk copy
// (cp.async.bulk, completing on the stage's full mbarrier) a row: 64 KB in
// flight a block, 128 KB an SM.  Consumers take 4-byte words tid, tid + 256,
// ... of every row, release the stage on its empty mbarrier, and store four
// means a word with st.global.cs.v4, so a warp's store covers 512 contiguous
// bytes.  The sum is integer: a row's four bytes of a word, biased by 128 to
// [0, 255], add as two pairs of 16-bit lanes of two int32 (bytes 0 and 2,
// bytes 1 and 3), at most 256 rows a pass.  Exactness: every decoded value
// is w * 2^-FL with |w| <= 128, an integer multiple of 2^-FL, and so is
// every partial sum, of magnitude < 128 n * 2^-FL; with n * 128 < 2^24 the
// float sum in any order is exact and equals float(sum of w) * 2^-FL, also
// exact (2^-FL from exponent bits, exp2i) while 128 n * 2^-FL stays finite
// (FL >= -100 for any n below 2^20).  The mean is then one IEEE division by
// n, a product with 1/n when n is a power of two (1/n exact, so the same
// correctly rounded quotient): bit-equal to the plain version and to the
// reference's jnp decode-then-mean, whatever the order.  The grid-stride body
// takes what a bulk copy cannot (a base, a row stride, the chunk or the
// quantum off 16 bytes): one element a thread, the table looked up each
// time.  No atomics: the same input gives the same bits on every run.  On an
// H100 80GB HBM3 at 700.00 W (kernel_ab.py, parent, this body twice, parent
// in one call; CUDA-graph replay, L2 flushed before each): 2.435 / 2.439 ms
// on owner 1's view of the [4, 803,385,344] chunk (2.25-2.58 launched
// directly at other stage settings; bound 1.919, 79-85 %) against 3.237 /
// 3.245 before; 0.496 / 0.568 on the overlap's [4, 176,160,768] w_in bucket
// (0.493-0.536 direct; bound 0.421) against 0.710 / 0.707; 0.497 / 0.499 on
// a contiguous [4, 176,160,768] stack against 0.705 / 0.708; 0.0080 / 0.0079
// on the smallest bucket (3,072 elements) against 0.0082 / 0.0083.  At the
// large shapes both bodies, the parent's too, read one of two levels about
// 10-15 % apart, changing between calls and between timings in one process;
// the cause is not found.
//
// No float atomics anywhere: the same input gives the same bits on every run.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PART = 7;          // partial row: count nonzero overflow abs_err rel abs_ref max

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

// Max and min that let NaN through, as torch.max and jnp.max do: one
// instruction each (max.NaN / min.NaN, sm_80 and later).
__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// Clamp that lets NaN through, as torch.clamp and jnp.clip do.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
    return min_nan(max_nan(v, lo), hi);
}

// floor(t) of a t with |t| < 2^22 in two full-rate adds: t + 1.5 * 2^23
// rounded down lands on an integer of [2^23, 2^24), where the float grid is
// 1.  Equal to floorf(t) there (t = -0.0 cannot occur: t = yc + u with
// u >= +0.0).
__device__ __forceinline__ float floor_small(float t) {
    return __fadd_rd(t, 12582912.0f) - 12582912.0f;
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

// A grid integer in [-128, 127] (or NaN) as an int8; NaN converts to 0, as
// it does in PyTorch's and XLA's float -> int8 casts.  v + 1.5 * 2^23 holds
// v's two's complement byte in its low mantissa bits: one full-rate add in
// place of a quarter-rate float -> int conversion.
__device__ __forceinline__ signed char to_i8(float v) {
    return v != v ? 0 : static_cast<signed char>(__float_as_int(v + 12582912.0f));
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

__device__ __forceinline__ void store4(signed char* p, const float* q) {
    char4 w;
    w.x = to_i8(q[0]); w.y = to_i8(q[1]); w.z = to_i8(q[2]); w.w = to_i8(q[3]);
    *reinterpret_cast<char4*>(p) = w;
}

__device__ __forceinline__ void store1(float* p, float q) { *p = q; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float q) {
    *p = __float2bfloat16_rn(q);
}
__device__ __forceinline__ void store1(signed char* p, float q) { *p = to_i8(q); }

// One element's (or a few elements') terms of the three float sums.
struct Sums {
    float abs_err = 0.0f, rel = 0.0f, abs_ref = 0.0f;
};

__device__ __forceinline__ Sums operator+(const Sums& a, const Sums& b) {
    Sums r;
    r.abs_err = a.abs_err + b.abs_err;
    r.rel = a.rel + b.rel;
    r.abs_ref = a.abs_ref + b.abs_ref;
    return r;
}

// Per-thread statistics: integer counts, double sums, a float max.
struct Acc {
    unsigned int cnt = 0u, nz = 0u, over = 0u;
    double abs_err = 0.0, rel = 0.0, abs_ref = 0.0;
    float mx = 0.0f;

    __device__ __forceinline__ void add(const Sums& t) {
        abs_err += t.abs_err;
        rel += t.rel;
        abs_ref += t.abs_ref;
    }
};

// One element onto the <IL, FL> grid.  SRC: 0 = round to nearest, else
// stochastic with `bits`.  WIRE saturates the grid integer to int8 and counts
// the saturation as overflow.  MASKED weighs the statistics by the mask `m`
// (1 keeps the element, 0 drops it).  The counts and the max go into `acc`,
// the element's terms of the three float sums into `t`.  Returns the value to
// store: q in grid units times 2^-FL (K1), or the saturated grid integer
// (wire).
// SMALL says the grid's span 2^(IL-1+FL) is at most 2^22, so floor_small
// gives floorf's bits.  COUNT keeps the kept-element count (K3; K1/K2 know
// it is n).
template <int SRC, bool WIRE, bool STATS, bool MASKED, bool SMALL = false, bool COUNT = true>
__device__ __forceinline__ float quant_one(float x, uint32_t bits, float m, const Grid& g,
                                           Acc& acc, Sums& t) {
    const float y = x * g.scale;
    const float yc = clamp_nan(y, g.qmin, g.qmax);
    // top 24 bits, logical shift -> uniform in [0, 1) on the 2^-24 grid
    const float r = yc + (SRC == 0 ? 0.5f
                                   : static_cast<float>(bits >> 8) * (1.0f / 16777216.0f));
    float k = SMALL ? floor_small(r) : floorf(r);
    k = clamp_nan(k, g.qmin, g.qmax);
    const float v = WIRE ? clamp_nan(k, -128.0f, 127.0f) : k;
    if (STATS) {
        const bool keep = !MASKED || m != 0.0f;
        const float x_ref = yc * g.inv_scale;              // range-clipped value
        const float abs_err = MASKED ? fabsf(v * g.inv_scale - x_ref) * m
                                     : fabsf(v * g.inv_scale - x_ref);
        const float abs_ref = MASKED ? fabsf(x_ref) * m : fabsf(x_ref);
        const bool nz = abs_ref > 0.0f;
        const bool over = (y > g.qmax) || (y < g.qmin) || (WIRE && k != v);
        if (COUNT) acc.cnt += keep ? 1u : 0u;
        acc.nz += nz ? 1u : 0u;
        acc.over += (over && keep) ? 1u : 0u;
        t.abs_err = abs_err;
        t.rel = nz ? abs_err / abs_ref : 0.0f;             // IEEE division
        t.abs_ref = abs_ref;
        acc.mx = max_nan(acc.mx, MASKED ? fabsf(x) * m : fabsf(x));
    }
    return WIRE ? (MASKED ? v * m : v) : v * g.inv_scale;
}

// quant_one with the element's float terms added to the double sums at once
template <int SRC, bool WIRE, bool STATS, bool MASKED>
__device__ __forceinline__ float quant_add(float x, uint32_t bits, float m, const Grid& g,
                                           Acc& acc) {
    Sums t;
    const float v = quant_one<SRC, WIRE, STATS, MASKED>(x, bits, m, g, acc, t);
    if (STATS) acc.add(t);
    return v;
}

struct Row {
    double v[PART - 1];
    float mx;
};

__device__ __forceinline__ Row to_row(const Acc& a) {
    Row r;
    r.v[0] = a.cnt; r.v[1] = a.nz; r.v[2] = a.over;
    r.v[3] = a.abs_err; r.v[4] = a.rel; r.v[5] = a.abs_ref;
    r.mx = a.mx;
    return r;
}

// Thread rows -> the block's row in thread 0: lanes, then warps in index order.
__device__ __forceinline__ void block_reduce_row(Row& r) {
    __shared__ Row part[THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < PART - 1; ++k) r.v[k] += __shfl_down_sync(0xffffffffu, r.v[k], o);
        r.mx = max_nan(r.mx, __shfl_down_sync(0xffffffffu, r.mx, o));
    }
    if (lane == 0) part[warp] = r;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < THREADS / 32; ++w) {
#pragma unroll
            for (int k = 0; k < PART - 1; ++k) r.v[k] += part[w].v[k];
            r.mx = max_nan(r.mx, part[w].mx);
        }
    }
}

__device__ __forceinline__ void write_row(double* dst, const Row& r) {
#pragma unroll
    for (int k = 0; k < PART - 1; ++k) dst[k] = r.v[k];
    dst[PART - 1] = r.mx;
}

// ---------------------------------------------------------------------------
// K1 / K1b / K2 / K2b
// ---------------------------------------------------------------------------

// groups of four elements a thread takes per iteration of the grid-stride
// loop without statistics (one with them); the wrapper reads it through
// dps_quant_groups_per_thread and sizes the grid by it
constexpr int Q_UNROLL = 4;

// The aligned part of K1/K2: U groups of four elements a thread per
// iteration (Q_UNROLL without statistics, one with them), `stride` groups
// apart so that each load instruction of a warp stays on consecutive
// addresses.  All the iteration's loads are issued before any is used; the
// Philox words are drawn while they are out.  The float terms of the
// iteration's elements are summed by a fixed pairwise tree (non-negative
// addends: relative error at most 4 * 2^-24), then added to the double sums
// with one conversion each.
template <typename XT, typename QT, int SRC, bool WIRE, bool STATS, bool SMALL>
__device__ __forceinline__ void quantize_groups(const XT* __restrict__ x, long long groups,
                                                const uint32_t* __restrict__ bits,
                                                unsigned long long seed,
                                                unsigned long long c0, QT* __restrict__ q,
                                                const Grid& g, Acc& acc, long long t0,
                                                long long stride) {
    constexpr int U = STATS ? 1 : Q_UNROLL;
    for (long long gb = t0; gb < groups; gb += U * stride) {
        float xv[U][4];
        uint32_t bv[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long gi = gb + u * stride;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                xv[u][j] = 0.0f;
                bv[u][j] = 0u;
            }
            if (gi < groups) {
                load4(x + 4 * gi, xv[u]);
                if (SRC == 1) {
                    const uint4 b = *reinterpret_cast<const uint4*>(bits + 4 * gi);
                    bv[u][0] = b.x; bv[u][1] = b.y; bv[u][2] = b.z; bv[u][3] = b.w;
                }
            }
        }
        // the pairwise tree ((g0 + g1) + (g2 + g3)), built as the groups finish
        Sums half[2];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long gi = gb + u * stride;
            if (SRC == 2) {
                const Philox4 r = philox4x32_10(c0 + static_cast<uint64_t>(gi), seed);
                bv[u][0] = r.v[0]; bv[u][1] = r.v[1]; bv[u][2] = r.v[2]; bv[u][3] = r.v[3];
            }
            if (gi < groups) {
                float qv[4];
                Sums t[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    qv[j] = quant_one<SRC, WIRE, STATS, false, SMALL, false>(
                        xv[u][j], bv[u][j], 1.0f, g, acc, t[j]);
                store4(q + 4 * gi, qv);
                const Sums grp = (t[0] + t[1]) + (t[2] + t[3]);
                half[u / 2] = (u % 2) ? half[u / 2] + grp : grp;
            }
        }
        if (STATS) acc.add(half[0] + half[1]);
    }
}

// bits source: 0 = round to nearest, 1 = bits operand, 2 = Philox in
// registers; element e takes word (ctr_base + e) % 4 of counter
// (ctr_base + e) / 4.  QT is x's type (K1) or signed char (WIRE, K2).  Four
// blocks of 256 threads fit an SM (at most 64 registers a thread), so the
// grid of kernels/dps_quant.py runs in one wave.
template <typename XT, typename QT, int SRC, bool WIRE, bool STATS, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
quantize_kernel(const XT* __restrict__ x, long long n, const int* __restrict__ il,
                const int* __restrict__ fl, const uint32_t* __restrict__ bits,
                unsigned long long seed, unsigned long long ctr_base, QT* __restrict__ q,
                double* __restrict__ partials) {
    const int ilv = *il, flv = *fl;
    const Grid g = make_grid(ilv, flv);
    Acc acc;
    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    const long long t0 = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const long long groups = n / 4;       // whole groups of four elements

    if (VEC) {
        // VEC with Philox needs ctr_base % 4 == 0 (the wrapper checks it)
        const unsigned long long c0 = ctr_base >> 2;
        // the span 2^(IL-1+FL) <= 2^22 (uniform across the grid)
        if (ilv - 1 + flv <= 22)
            quantize_groups<XT, QT, SRC, WIRE, STATS, true>(x, groups, bits, seed, c0, q, g,
                                                            acc, t0, stride);
        else
            quantize_groups<XT, QT, SRC, WIRE, STATS, false>(x, groups, bits, seed, c0, q, g,
                                                             acc, t0, stride);
    }
    // scalar path: everything when aligned access is not possible, else the
    // ragged tail of fewer than four elements
    for (long long e = (VEC ? 4 * groups : 0) + t0; e < n; e += stride) {
        uint32_t b = 0u;
        if (SRC == 1) b = bits[e];
        if (SRC == 2) {
            const unsigned long long c = ctr_base + static_cast<unsigned long long>(e);
            b = philox4x32_10(c >> 2, seed).v[c & 3];
        }
        Sums t;
        store1(q + e, quant_one<SRC, WIRE, STATS, false, false, false>(to_f32(x[e]), b, 1.0f,
                                                                       g, acc, t));
        if (STATS) acc.add(t);
    }

    if (STATS) {
        Row r = to_row(acc);
        block_reduce_row(r);
        if (threadIdx.x == 0) write_row(partials + static_cast<long long>(blockIdx.x) * PART, r);
    }
}

// Second stage: one block folds the per-block partials in block order and
// writes the seven float32 statistics (count nonzero overflow abs_err_sum
// rel_err_sum abs_sum max_abs).  The count is n.
__global__ void __launch_bounds__(THREADS)
quantize_stats_kernel(const double* __restrict__ partials, int nblocks, long long n,
                      float* __restrict__ stats) {
    Row r = {{0.0, 0.0, 0.0, 0.0, 0.0, 0.0}, 0.0f};
    for (int b = threadIdx.x; b < nblocks; b += THREADS) {
        const double* p = partials + static_cast<long long>(b) * PART;
#pragma unroll
        for (int k = 0; k < PART - 1; ++k) r.v[k] += p[k];
        r.mx = max_nan(r.mx, static_cast<float>(p[PART - 1]));
    }
    block_reduce_row(r);
    if (threadIdx.x == 0) {
        stats[0] = static_cast<float>(n);
#pragma unroll
        for (int k = 1; k < PART - 1; ++k) stats[k] = static_cast<float>(r.v[k]);
        stats[6] = r.mx;
    }
}

template <typename XT, typename QT, int SRC, bool WIRE, bool STATS>
void launch_quantize(bool vec, int nblocks, cudaStream_t s, const XT* x, long long n,
                     const int* il, const int* fl, const uint32_t* bits,
                     unsigned long long seed, unsigned long long ctr, QT* q, double* partials) {
    if (vec)
        quantize_kernel<XT, QT, SRC, WIRE, STATS, true><<<nblocks, THREADS, 0, s>>>(
            x, n, il, fl, bits, seed, ctr, q, partials);
    else
        quantize_kernel<XT, QT, SRC, WIRE, STATS, false><<<nblocks, THREADS, 0, s>>>(
            x, n, il, fl, bits, seed, ctr, q, partials);
}

template <typename XT, typename QT, bool WIRE>
void dispatch_quantize(int src, bool stats, bool vec, int nblocks, cudaStream_t s,
                       const XT* x, long long n, const int* il, const int* fl,
                       const uint32_t* bits, unsigned long long seed, unsigned long long ctr,
                       QT* q, double* partials) {
#define DPS_Q(SRC, ST) launch_quantize<XT, QT, SRC, WIRE, ST>(vec, nblocks, s, x, n, il, fl, \
                                                             bits, seed, ctr, q, partials)
    if (src == 0) { if (stats) DPS_Q(0, true); else DPS_Q(0, false); }
    else if (src == 1) { if (stats) DPS_Q(1, true); else DPS_Q(1, false); }
    else { if (stats) DPS_Q(2, true); else DPS_Q(2, false); }
#undef DPS_Q
}

// ---------------------------------------------------------------------------
// K3 / K3b
// ---------------------------------------------------------------------------

// Element e (from 0) of tile t lies at position start + t*quantum + e of the
// aligned layout.  SRC 2 (K3b): group g's stream is keyed on
// fold_seed(seed, group_base + g) and counts from goff[g], the group's
// aligned offset.  MASKED: `mask` is not null.
template <typename XT, int SRC, bool STATS, bool MASKED, bool VEC>
__global__ void __launch_bounds__(THREADS)
group_wire_encode_kernel(const XT* __restrict__ x, const int* __restrict__ fmt_tab,
                         const int* __restrict__ tile_group,
                         const uint32_t* __restrict__ bits,
                         const float* __restrict__ mask, unsigned long long seed,
                         const long long* __restrict__ goff, long long start,
                         long long group_base, signed char* __restrict__ wire,
                         double* __restrict__ partials, long long quantum) {
    const long long t = blockIdx.x;
    const int grp = tile_group[t];
    const Grid g = make_grid(fmt_tab[2 * grp], fmt_tab[2 * grp + 1]);
    const long long base = t * quantum;
    unsigned long long gseed = 0ull;
    long long gpos = 0;                  // index of the tile's first element in its group
    if (SRC == 2) {
        gseed = fold_seed(seed, static_cast<unsigned long long>(group_base + grp));
        gpos = start + base - goff[grp];
    }
    Acc acc;

    // four elements a step when the quantum divides by four and, for Philox,
    // the tile starts on a counter boundary (uniform across the block)
    const bool vec = VEC && (SRC != 2 || (gpos & 3) == 0);
    const long long nvec = vec ? quantum / 4 : 0;
    for (long long i = threadIdx.x; i < nvec; i += THREADS) {
        const long long e = base + 4 * i;
        float xv[4], wv[4];
        load4(x + e, xv);
        uint32_t bv[4] = {0u, 0u, 0u, 0u};
        if (SRC == 1) {
            const uint4 b = *reinterpret_cast<const uint4*>(bits + e);
            bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
        } else if (SRC == 2) {
            const Philox4 r = philox4x32_10(static_cast<uint64_t>((gpos >> 2) + i), gseed);
            bv[0] = r.v[0]; bv[1] = r.v[1]; bv[2] = r.v[2]; bv[3] = r.v[3];
        }
        float mv[4] = {1.0f, 1.0f, 1.0f, 1.0f};
        if (MASKED) load4(mask + e, mv);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wv[j] = quant_add<SRC, true, STATS, MASKED>(xv[j], bv[j], mv[j], g, acc);
        store4(wire + e, wv);
    }
    // scalar tail: everything when the vector path is off
    for (long long i = 4 * nvec + threadIdx.x; i < quantum; i += THREADS) {
        const long long e = base + i;
        uint32_t b = 0u;
        if (SRC == 1) b = bits[e];
        if (SRC == 2) {
            const unsigned long long c = static_cast<unsigned long long>(gpos + i);
            b = philox4x32_10(c >> 2, gseed).v[c & 3];
        }
        const float m = MASKED ? mask[e] : 1.0f;
        store1(wire + e, quant_add<SRC, true, STATS, MASKED>(to_f32(x[e]), b, m, g, acc));
    }

    if (STATS) {
        Row r = to_row(acc);
        block_reduce_row(r);
        if (threadIdx.x == 0) write_row(partials + t * PART, r);
    }
}

// Second stage: block g folds partials[t] of every tile with
// tile_group[t] == g into stats[g] (sums add, the max column maxes; a group
// without tiles gets zeros), in double, in a fixed order.
__global__ void __launch_bounds__(THREADS)
group_stats_reduce_kernel(const double* __restrict__ partials,
                          const int* __restrict__ tile_group,
                          float* __restrict__ stats, long long tiles) {
    const int grp = blockIdx.x;
    Row r = {{0.0, 0.0, 0.0, 0.0, 0.0, 0.0}, 0.0f};
    for (long long t = threadIdx.x; t < tiles; t += THREADS) {
        if (tile_group[t] != grp) continue;
        const double* p = partials + t * PART;
#pragma unroll
        for (int k = 0; k < PART - 1; ++k) r.v[k] += p[k];
        r.mx = max_nan(r.mx, static_cast<float>(p[PART - 1]));
    }
    block_reduce_row(r);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < PART - 1; ++k) stats[grp * PART + k] = static_cast<float>(r.v[k]);
        stats[grp * PART + PART - 1] = r.mx;
    }
}

template <typename XT, int SRC, bool STATS, bool MASKED>
void launch_encode(bool vec, unsigned tiles, cudaStream_t s, const XT* x,
                   const int* fmt_tab, const int* tile_group, const uint32_t* bits,
                   const float* mask, unsigned long long seed, const long long* goff,
                   long long start, long long group_base, signed char* wire,
                   double* partials, long long quantum) {
    if (vec)
        group_wire_encode_kernel<XT, SRC, STATS, MASKED, true><<<tiles, THREADS, 0, s>>>(
            x, fmt_tab, tile_group, bits, mask, seed, goff, start, group_base, wire,
            partials, quantum);
    else
        group_wire_encode_kernel<XT, SRC, STATS, MASKED, false><<<tiles, THREADS, 0, s>>>(
            x, fmt_tab, tile_group, bits, mask, seed, goff, start, group_base, wire,
            partials, quantum);
}

template <typename XT, int SRC>
void dispatch_encode_src(bool stats, bool masked, bool vec, unsigned tiles, cudaStream_t s,
                         const XT* x, const int* fmt_tab, const int* tile_group,
                         const uint32_t* bits, const float* mask, unsigned long long seed,
                         const long long* goff, long long start, long long group_base,
                         signed char* wire, double* partials, long long quantum) {
#define DPS_E(ST, MK) launch_encode<XT, SRC, ST, MK>(vec, tiles, s, x, fmt_tab, tile_group, \
                                                   bits, mask, seed, goff, start, group_base, \
                                                   wire, partials, quantum)
    if (stats) { if (masked) DPS_E(true, true); else DPS_E(true, false); }
    else { if (masked) DPS_E(false, true); else DPS_E(false, false); }
#undef DPS_E
}

template <typename XT>
void dispatch_encode(int src, bool stats, bool masked, bool vec, unsigned tiles,
                     cudaStream_t s, const XT* x, const int* fmt_tab, const int* tile_group,
                     const uint32_t* bits, const float* mask, unsigned long long seed,
                     const long long* goff, long long start, long long group_base,
                     signed char* wire, double* partials, long long quantum) {
    if (src == 0)
        dispatch_encode_src<XT, 0>(stats, masked, vec, tiles, s, x, fmt_tab, tile_group, bits,
                                   mask, seed, goff, start, group_base, wire, partials, quantum);
    else if (src == 1)
        dispatch_encode_src<XT, 1>(stats, masked, vec, tiles, s, x, fmt_tab, tile_group, bits,
                                   mask, seed, goff, start, group_base, wire, partials, quantum);
    else
        dispatch_encode_src<XT, 2>(stats, masked, vec, tiles, s, x, fmt_tab, tile_group, bits,
                                   mask, seed, goff, start, group_base, wire, partials, quantum);
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

// The grid-stride body: what the TMA body cannot take (a row base, a row
// stride, the chunk or the quantum off 16 bytes).  One element a thread an
// iteration, the table looked up for each.
__global__ void __launch_bounds__(THREADS)
wire_reduce_stride_kernel(const signed char* __restrict__ wire, long long row_stride,
                          int n_ranks, long long chunk, const int* __restrict__ fmt_tab,
                          const int* __restrict__ tile_group, long long quantum,
                          float* __restrict__ out) {
    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    const float nf = static_cast<float>(n_ranks);
    for (long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; e < chunk;
         e += stride) {
        const int grp = tile_group != nullptr ? tile_group[e / quantum] : 0;
        const float inv = exp2i(-fmt_tab[2 * grp + 1]);
        float s = 0.0f;
        for (int r = 0; r < n_ranks; ++r) s += static_cast<float>(wire[r * row_stride + e]) * inv;
        out[e] = s / nf;
    }
}

// The TMA body.  A block is RED_CONSUMERS consumer threads and one producer
// warp; a ring of `stages` stages in dynamic shared memory, each holding the
// n rows of one item (`span` bytes a row), then the stages' full and empty
// mbarriers and each stage's 2^-FL.  Items are the spans of `span` elements
// inside each tile (`ipt` a tile, the last one of a tile shorter when span
// does not divide the quantum), so an item has one format; block b takes
// items b, b + gridDim.x, ...
constexpr int RED_CONSUMERS = 256;
constexpr int RED_THREADS = RED_CONSUMERS + 32;
constexpr int RED_UNROLL = 4;                       // words a consumer holds at once
constexpr int RED_MAX_SMEM = 232448;                // 227 KB, a block's most on sm_90
constexpr int RED_PACK_ROWS = 256;                  // rows a 16-bit lane sum can take

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

// Wait for the phase of parity `parity` to complete.  A barrier that never
// completes is a fault of this file: after about 2^32 cycles (over two
// seconds) the kernel traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    long long t0 = 0;
#pragma unroll 1
    for (int spin = 0;; ++spin) {
        uint32_t done;
        asm volatile(
            "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
            "selp.u32 %0, 1, 0, p; }"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (done) return;
        if (spin == 0)
            t0 = clock64();
        else if (clock64() - t0 > (1ll << 32))
            __trap();
    }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// Item i: elements [start, start + len) of the chunk, len <= 0 for the
// empty spans past a ragged last tile.
__device__ __forceinline__ void red_item(long long i, long long ipt, long long quantum,
                                         long long chunk, int span, long long& t,
                                         long long& start, int& len) {
    t = i / ipt;
    start = t * quantum + (i - t * ipt) * span;
    const long long end = min(t * quantum + quantum, chunk);
    len = static_cast<int>(max(min(static_cast<long long>(span), end - start), -1ll));
}

__global__ void __launch_bounds__(RED_THREADS, 2)
wire_reduce_tma_kernel(const signed char* __restrict__ wire, long long row_stride,
                       int n_ranks, long long chunk, const int* __restrict__ fmt_tab,
                       const int* __restrict__ tile_group, long long quantum, int span,
                       int stages, float* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char red_smem[];
    const long long stage_bytes = static_cast<long long>(n_ranks) * span;
    unsigned char* data = red_smem;
    uint64_t* full = reinterpret_cast<uint64_t*>(red_smem + stages * stage_bytes);
    uint64_t* empty = full + stages;
    float* sinv = reinterpret_cast<float*>(empty + stages);
    const long long ipt = (quantum + span - 1) / span;
    const long long items = (chunk + quantum - 1) / quantum * ipt;
    const int tid = threadIdx.x;

    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(smem_u32(full + s), 1);
            mbar_init(smem_u32(empty + s), RED_CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= RED_CONSUMERS) {
        // the producer: one thread issues every row's bulk copy of an item
        // once the consumers have freed its stage; the item's 2^-FL goes to
        // the stage beside it (the table loads are issued before the wait)
        if (tid != RED_CONSUMERS) return;
        int k = 0;
        for (long long i = blockIdx.x; i < items; i += gridDim.x) {
            long long t, start;
            int len;
            red_item(i, ipt, quantum, chunk, span, t, start, len);
            if (len <= 0) continue;
            const int grp = tile_group != nullptr ? __ldg(tile_group + t) : 0;
            const float inv = exp2i(-__ldg(fmt_tab + 2 * grp + 1));
            const int s = k % stages;
            if (k >= stages) mbar_wait(smem_u32(empty + s), ((k / stages) & 1) ^ 1);
            sinv[s] = inv;
            const uint32_t bar = smem_u32(full + s);
            mbar_arrive_tx(bar, static_cast<uint32_t>(n_ranks) * len);
            const uint32_t dst = smem_u32(data + s * stage_bytes);
            for (int r = 0; r < n_ranks; ++r)
                bulk_load(dst + r * span, wire + r * row_stride + start, len, bar);
            ++k;
        }
        return;
    }

    // the consumers: thread tid takes the 4-byte words tid, tid + 256, ... of
    // every row of the stage, so each float4 store of a warp covers 512
    // contiguous bytes of the output.  A word's four int8 of a row, biased
    // by 128 to [0, 255], are summed over the rows as two pairs of 16-bit
    // lanes (bytes 0 and 2, bytes 1 and 3) of two int32: at most 256 rows a
    // pass, so no lane carries into the next.
    const bool pow2 = (n_ranks & (n_ranks - 1)) == 0;
    const float nf = static_cast<float>(n_ranks);
    const float rn = 1.0f / nf;                      // exact when n is a power of two
    int k = 0;
    for (long long i = blockIdx.x; i < items; i += gridDim.x) {
        long long t, start;
        int len;
        red_item(i, ipt, quantum, chunk, span, t, start, len);
        if (len <= 0) continue;
        const int s = k % stages;
        mbar_wait(smem_u32(full + s), (k / stages) & 1);
        const float inv = sinv[s];
        const unsigned char* st = data + s * stage_bytes;
        const int words = len >> 2;
        for (int w0 = tid; w0 < words; w0 += RED_UNROLL * RED_CONSUMERS) {
            int sum[RED_UNROLL][4];
#pragma unroll
            for (int u = 0; u < RED_UNROLL; ++u)
#pragma unroll
                for (int b = 0; b < 4; ++b) sum[u][b] = 0;
            for (int r0 = 0; r0 < n_ranks; r0 += RED_PACK_ROWS) {
                const int r1 = min(n_ranks, r0 + RED_PACK_ROWS);
                uint32_t lo[RED_UNROLL], hi[RED_UNROLL];
#pragma unroll
                for (int u = 0; u < RED_UNROLL; ++u) lo[u] = hi[u] = 0u;
                for (int r = r0; r < r1; ++r) {
                    const uint32_t* row = reinterpret_cast<const uint32_t*>(st + r * span);
#pragma unroll
                    for (int u = 0; u < RED_UNROLL; ++u) {
                        const int w = w0 + u * RED_CONSUMERS;
                        if (w < words) {
                            const uint32_t x = row[w] ^ 0x80808080u;
                            lo[u] += x & 0x00ff00ffu;
                            hi[u] += (x >> 8) & 0x00ff00ffu;
                        }
                    }
                }
                const int bias = 128 * (r1 - r0);
#pragma unroll
                for (int u = 0; u < RED_UNROLL; ++u) {
                    sum[u][0] += static_cast<int>(lo[u] & 0xffffu) - bias;
                    sum[u][1] += static_cast<int>(hi[u] & 0xffffu) - bias;
                    sum[u][2] += static_cast<int>(lo[u] >> 16) - bias;
                    sum[u][3] += static_cast<int>(hi[u] >> 16) - bias;
                }
            }
#pragma unroll
            for (int u = 0; u < RED_UNROLL; ++u) {
                const int w = w0 + u * RED_CONSUMERS;
                if (w >= words) continue;
                float m[4];
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const float v = static_cast<float>(sum[u][b]) * inv;   // exact
                    m[b] = pow2 ? v * rn : v / nf;
                }
                __stcs(reinterpret_cast<float4*>(out + start) + w,
                       make_float4(m[0], m[1], m[2], m[3]));
            }
        }
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(smem_u32(empty + s));
        ++k;
    }
}

}  // namespace

// K1 / K1b / K2 / K2b.  All pointers are device pointers; `il`/`fl` point at
// one int32 each.  `src`: 0 = round to nearest, 1 = stochastic with the
// `bits` operand, 2 = stochastic with Philox bits keyed on `seed`, element e
// taking word (ctr_base + e) % 4 of counter (ctr_base + e) / 4.  `wire` 0
// writes q in x's type (K1), 1 writes the int8 wire payload (K2).
// `partials` (double [nblocks, 7]) and `stats` (float [7]) null means no
// statistics.  `vec` says the caller checked the alignment of x, q and bits
// (and ctr_base % 4 == 0 under Philox).  The caller sizes the grid
// (`nblocks`) as a function of n and of dps_quant_groups_per_thread(stats)
// alone, so the statistics' summation order, too, depends on n alone.  Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
// Groups of four elements a K1/K2 thread takes per iteration: Q_UNROLL
// without statistics, one with them.
extern "C" int dps_quant_groups_per_thread(int stats) { return stats ? 1 : Q_UNROLL; }

extern "C" int dps_quantize(const void* x, int x_is_bf16, long long n, const void* il,
                            const void* fl, const void* bits, int src,
                            unsigned long long seed, unsigned long long ctr_base, void* q,
                            int wire, void* partials, void* stats, int nblocks, int vec,
                            void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool emit = partials != nullptr && stats != nullptr;
    if (src < 0 || src > 2 || nblocks < 1 || (src == 1 && bits == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const int* ilp = static_cast<const int*>(il);
    const int* flp = static_cast<const int*>(fl);
    const uint32_t* bp = static_cast<const uint32_t*>(bits);
    double* pp = static_cast<double*>(partials);
    if (n > 0) {
        if (x_is_bf16) {
            const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
            if (wire)
                dispatch_quantize<__nv_bfloat16, signed char, true>(
                    src, emit, vec != 0, nblocks, s, xp, n, ilp, flp, bp, seed, ctr_base,
                    static_cast<signed char*>(q), pp);
            else
                dispatch_quantize<__nv_bfloat16, __nv_bfloat16, false>(
                    src, emit, vec != 0, nblocks, s, xp, n, ilp, flp, bp, seed, ctr_base,
                    static_cast<__nv_bfloat16*>(q), pp);
        } else {
            const float* xp = static_cast<const float*>(x);
            if (wire)
                dispatch_quantize<float, signed char, true>(
                    src, emit, vec != 0, nblocks, s, xp, n, ilp, flp, bp, seed, ctr_base,
                    static_cast<signed char*>(q), pp);
            else
                dispatch_quantize<float, float, false>(
                    src, emit, vec != 0, nblocks, s, xp, n, ilp, flp, bp, seed, ctr_base,
                    static_cast<float*>(q), pp);
        }
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (emit) {
        quantize_stats_kernel<<<1, THREADS, 0, s>>>(pp, n > 0 ? nblocks : 0, n,
                                                    static_cast<float*>(stats));
    }
    return static_cast<int>(cudaGetLastError());
}

// K3 / K3b.  All pointers are device pointers.  `src`: 0 = round to
// nearest, 1 = the `bits` operand, 2 = Philox keyed per group (`seed`,
// `goff` int64 [G], `start`, `group_base`; see group_wire_encode_kernel).
// `mask` null means every element counts; `partials` (double [tiles, 7]) and
// `stats` (float [G, 7]) null means no statistics.  `vec` says the caller
// checked that the quantum divides by four and the buffers are 16-byte
// aligned.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int dps_group_wire_encode(const void* x, int x_is_bf16, const void* fmt_tab,
                                     const void* tile_group, const void* bits,
                                     const void* mask, int src, unsigned long long seed,
                                     const void* goff, long long start, long long group_base,
                                     void* wire, void* partials, void* stats, long long tiles,
                                     long long quantum, int groups, int vec, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool emit = partials != nullptr && stats != nullptr;
    if (src < 0 || src > 2 || (src == 1 && bits == nullptr) || (src == 2 && goff == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const int* tab = static_cast<const int*>(fmt_tab);
    const int* tg = static_cast<const int*>(tile_group);
    const uint32_t* bp = static_cast<const uint32_t*>(bits);
    const float* mp = static_cast<const float*>(mask);
    const long long* gp = static_cast<const long long*>(goff);
    signed char* wp = static_cast<signed char*>(wire);
    double* pp = static_cast<double*>(partials);
    if (tiles > 0 && quantum > 0) {
        const unsigned nt = static_cast<unsigned>(tiles);
        const bool masked = mp != nullptr;
        if (x_is_bf16)
            dispatch_encode<__nv_bfloat16>(src, emit, masked, vec != 0, nt, s,
                                           static_cast<const __nv_bfloat16*>(x), tab, tg, bp,
                                           mp, seed, gp, start, group_base, wp, pp, quantum);
        else
            dispatch_encode<float>(src, emit, masked, vec != 0, nt, s,
                                   static_cast<const float*>(x), tab, tg, bp, mp, seed, gp,
                                   start, group_base, wp, pp, quantum);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (emit && groups > 0) {
        group_stats_reduce_kernel<<<static_cast<unsigned>(groups), THREADS, 0, s>>>(
            pp, tg, static_cast<float*>(stats), tiles > 0 ? tiles : 0);
    }
    return static_cast<int>(cudaGetLastError());
}

// K4.  `wire`: int8, row r of the [n_ranks, chunk] stack at
// wire + r * row_stride.  `fmt_tab`: int32 [G, 2]; `tile_group`: int32
// [ceil(chunk / quantum)] (null: every tile takes row 0).  `out`: fp32
// [chunk].  `body` 1 is the TMA body, `span` elements a row a stage and
// `stages` stages: the caller checked that wire, out, row_stride, chunk and
// quantum are 16-byte multiples and that the stages fit in 227 KB.  `body` 0
// is the grid-stride body (`span` and `stages` unused).  `nblocks` is the
// grid.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int dps_wire_reduce(const void* wire, long long row_stride, int n_ranks,
                               long long chunk, const void* fmt_tab, const void* tile_group,
                               long long quantum, void* out, int nblocks, int body, int span,
                               int stages, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_ranks < 1 || quantum < 1 || nblocks < 1 || body < 0 || body > 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const signed char* wp = static_cast<const signed char*>(wire);
    const int* tab = static_cast<const int*>(fmt_tab);
    const int* tg = static_cast<const int*>(tile_group);
    float* op = static_cast<float*>(out);
    if (chunk <= 0) return static_cast<int>(cudaGetLastError());
    if (body == 0) {
        wire_reduce_stride_kernel<<<nblocks, THREADS, 0, s>>>(wp, row_stride, n_ranks, chunk,
                                                             tab, tg, quantum, op);
        return static_cast<int>(cudaGetLastError());
    }
    const long long smem = static_cast<long long>(stages) * n_ranks * span + 20ll * stages;
    if (stages < 1 || span < 16 || span % 16 || quantum % 16 || chunk % 16 ||
        (n_ranks > 1 && row_stride % 16) || reinterpret_cast<uintptr_t>(wp) % 16 ||
        reinterpret_cast<uintptr_t>(op) % 16 || smem > RED_MAX_SMEM)
        return static_cast<int>(cudaErrorInvalidValue);
    // set once to the most a block may have, so that no later launch (one
    // captured into a CUDA graph included) needs the call
    static bool attr = false;
    if (!attr) {
        const cudaError_t err = cudaFuncSetAttribute(
            wire_reduce_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RED_MAX_SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        attr = true;
    }
    wire_reduce_tma_kernel<<<nblocks, RED_THREADS, static_cast<size_t>(smem), s>>>(
        wp, row_stride, n_ranks, chunk, tab, tg, quantum, span, stages, op);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
