// The DPS quantizer kernels for Hopper (sm_90a): K1/K1b/K2/K2b, K3/K3b, K4.
//
// K1 / K1b / K2 / K2b (`quantize_kernel`, `quantize_tma_kernel`) replace `_kernel` of
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
// One launch a call, with two bodies.  The statistics: each block reduces
// its threads' rows (integer counts, double sums) lane -> warp -> block,
// writes its row, and the block that takes the last ticket of an int
// counter folds the rows in block order into the seven float32 statistics
// and sets the ticket back (finish_stats).  The wrapper keeps one ticket a
// device; the port launches every quantizer on one stream, and a second
// stream would need a ticket of its own.
//
// Bound on this card: bytes without statistics (K1b moves 8 B an fp32
// element, K2b 5, a bits operand 4 more), issue with them: ~200-230
// instructions a group of four (Philox4x32-10 ~40, an IEEE division a
// element ~10, the clips, counts, sums and the max), at an IPC near 0.6
// with 16 consumer warps an SM (in-kernel clock 1.98 GHz), ~3 us for a
// 4,096-element item a block.  At the placed step's blocks (10^5 to
// ~3*10^7 elements) that, the first stage's arrival (~2.7 us) and the fold
// (~1.9 us) set the time; at 704 M elements the bytes and the issue nearly
// tie (K1b 2.00 ms with statistics, 1.94 without, bound 1.68).
//
// The grid-stride body (`quantize_kernel`, the earlier design): a 1-D pass over
// the flat tensor in groups of four elements (16-byte loads of fp32 x and
// bits and a 4- or 16-byte store when the pointers allow, a scalar tail by
// predicate, so no pad or mask copies), four blocks of 256 threads an SM
// (at most 64 registers a thread), one wave.  Without statistics a thread
// takes four groups an iteration, all four loads issued before the first is
// used and the Philox words drawn while they are out; with statistics one
// group (more spills the 64 registers and is slower, measured).  The float
// terms of the sums add in a fixed pairwise tree over the group and go to
// double once a group; counts are integers; the grid's span <= 2^22 floors
// by two adds, NaN-propagating clips are one instruction each, the int8
// byte comes from an add (no quarter-rate conversions).  In block mode each
// group's counter costs two 64-bit divisions (geo_index).
//
// The TMA body (`quantize_tma_kernel`, q in x's type from Philox bits or to
// nearest): a persistent grid of two blocks an SM, each 256 consumer
// threads and one producer warp, and a ring of three 16 KB stages of x in
// dynamic shared memory, each filled by one bulk copy (cp.async.bulk,
// completing on the stage's full mbarrier) of one item: a span of the storage inside one row of the
// block's [n0, n1, n2], or whole rows of one slab (kernels/dps_quant.py's
// quant_plan cuts them; block b takes items b, b + grid, ...).  The
// producer works out an item's header (its start, length and first Philox
// counter: two 64-bit divisions an item) beside the stage; the consumers
// take groups tid, tid + 256, ... from shared memory, store q with one
// store a group, and step their counters by a constant with one carry at a
// row's end: no division a group.  Their statistics are in grid units,
// scaled by 2^-FL once (exact), with the division on operands made nonzero
// (a zero operand sends the whole warp down the division's slow path: an
// input of zeros read 41 us for 29) and no branch round it, a thread's
// groups of an item summed in float, the item to double once.  The producer
// thread, which stores no q, takes the block's ticket.  <IL, FL> are
// read from device memory by every block (the controller moves them on the
// device every step).  The output may be a slice of a larger buffer (the
// wire path writes each leaf straight into its slot of a rank's payload).
//
// Where the plan cuts: the TMA body takes every block (K1b's block mode,
// where the grid-stride body divides twice a group) and a contiguous
// launch of 2^24 elements or more without a bits operand onto q (K1b, or
// to nearest); the rest goes to the grid-stride body, which measured as
// fast or faster there, or within 2 % (kernel_ab.py --only bodies, H100
// 80GB HBM3 at 700.00 W, TMA over grid-stride with statistics: K1b
// 0.958-0.981 at 25-704 M elements but 1.08-1.17 at <= 6.3 M, where 528
// blocks start on their first 16-byte loads while a 16 KB stage is still
// in flight; and, while the TMA body also carried a bits operand beside x
// and the int8 wire, K2b 1.09-1.17 at every size, where the grid-stride
// body's 32 warps an SM issue more than 16, K1 1.00-1.15, K2 1.01-1.16 up
// to 25 M and 0.98-0.99 above: so it carries neither).  More consumer warps made the TMA body slower (three
// blocks at 72 registers; four at 56, or 1,024 threads at 64, spill), and
// claiming items dynamically gained 4 % at 704 M elements and lost at
// 6.3 M.  On that card (kernel_ab.py, parent, this design twice, parent in
// one call; CUDA-graph replay, the L2 flushed by a read): one rank's block
// of a w_in layer at (1, 4), 6,291,456 fp32, 0.0288 / 0.0285 ms against
// 0.0307 / 0.0306 (bound 0.0150); at (2, 4) 0.0194 / 0.0196 against
// 0.0197 / 0.0194; the 28-layer w_in block at (1, 4) 0.506 / 0.506 against
// 0.573 / 0.574; K1b on the 704,643,072-value w_in leaf 2.015 / 2.000
// against 2.102 / 2.107 (bound 1.683); K1, K2 and K2b within 0.3 % of the
// parent; one device kernel a call where there were two.
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
// a wire chunk moves 5 B per element.  K3b is near the issue limit as well
// (Philox4x32-10, ~40 instructions a group of four), and with statistics
// beyond it.  A persistent grid (kernels/dps_quant.py's group_plan): four
// blocks of 256 threads an SM over items of about 16 KB of x — pieces of a
// larger tile, runs of whole smaller ones, smaller items where a launch has
// fewer than four a block — block b taking items b, b + grid, ...  So a
// launch of few tiles (an admission of 128 pages) spreads over every SM, one
// of many (a wire chunk: 196,139 tiles of 4,096) pays a block's set-up once,
// and the card sweeps the buffer front to back.  A thread issues four
// 16-byte loads of x (and of the mask and the bits) before it uses one, with
// no guard between them where the whole batch lies in the piece; the tile's
// format row is read and the Philox words drawn while they are out, so a
// piece's first loads wait for nothing, its tile's group read one piece
// ahead and waited for only where the statistics or the Philox key change
// with it.  K3b's counter steps by one a group of four from the piece's
// group-relative position, no division; a piece's tile and place step with
// one carry, no division a piece.  The statistics: a block keeps one running
// row (integer counts, a batch's float terms added in float, to double once)
// while its pieces share a group, and writes it to its next slot when the
// group changes; the block that takes the last ticket folds the rows into
// [G, 7] (group_fold).  One launch a call: the counts stay exact past 2^24
// elements and the same input gives the same bits every run.  The relative
// error's IEEE division takes nonzero operands (a zero sends the warp down
// the slow path, as measured on K1b's TMA body).  Measured, and left out
// (kernel_ab.py --only k3, H100 80GB HBM3 at 700.00 W, on trees of this
// body's earlier forms, against the parent in the same call): each block
// taking one contiguous span of the buffer (items b * span ...) read the
// same to 3 % slower at every shape; six or eight blocks an SM (40 or 32
// registers, with fewer loads a thread) 2-39 % slower, spilling; evict-first
// loads and stores (ld.global.cs) 3-8 % faster at the llama, qwen3-moe and
// mistral admissions but 4-8 % slower at gemma's and on every K3b chunk;
// with statistics, two loads a thread in flight 4-15 % slower than four.
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

// One element onto the <IL, FL> grid (K1/K2; K3's is wire_one).  SRC: 0 =
// round to nearest, else stochastic with `bits`.  WIRE saturates the grid
// integer to int8 and counts the saturation as overflow.  The counts and the
// max go into `acc` (not the element count: K1/K2 know it is n), the
// element's terms of the three float sums into `t`.  Returns the value to
// store: q in grid units times 2^-FL (K1), or the saturated grid integer
// (wire).  SMALL says the grid's span 2^(IL-1+FL) is at most 2^22, so
// floor_small gives floorf's bits.
template <int SRC, bool WIRE, bool STATS, bool SMALL = false>
__device__ __forceinline__ float quant_one(float x, uint32_t bits, const Grid& g, Acc& acc,
                                           Sums& t) {
    const float y = x * g.scale;
    const float yc = clamp_nan(y, g.qmin, g.qmax);
    // top 24 bits, logical shift -> uniform in [0, 1) on the 2^-24 grid
    const float r = yc + (SRC == 0 ? 0.5f
                                   : static_cast<float>(bits >> 8) * (1.0f / 16777216.0f));
    float k = SMALL ? floor_small(r) : floorf(r);
    k = clamp_nan(k, g.qmin, g.qmax);
    const float v = WIRE ? clamp_nan(k, -128.0f, 127.0f) : k;
    if (STATS) {
        const float x_ref = yc * g.inv_scale;              // range-clipped value
        const float abs_err = fabsf(v * g.inv_scale - x_ref);
        const float abs_ref = fabsf(x_ref);
        const bool nz = abs_ref > 0.0f;
        const bool over = (y > g.qmax) || (y < g.qmin) || (WIRE && k != v);
        acc.nz += nz ? 1u : 0u;
        acc.over += over ? 1u : 0u;
        t.abs_err = abs_err;
        t.rel = nz ? abs_err / abs_ref : 0.0f;             // IEEE division
        t.abs_ref = abs_ref;
        acc.mx = max_nan(acc.mx, fabsf(x));
    }
    return WIRE ? v : v * g.inv_scale;
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

// Thread rows -> the block's row in thread ROOT: lanes, then the block's
// WARPS warps in index order.
template <int WARPS = THREADS / 32, int ROOT = 0>
__device__ __forceinline__ void block_reduce_row(Row& r) {
    __shared__ Row part[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < PART - 1; ++k) r.v[k] += __shfl_down_sync(0xffffffffu, r.v[k], o);
        r.mx = max_nan(r.mx, __shfl_down_sync(0xffffffffu, r.mx, o));
    }
    if (lane == 0) part[warp] = r;
    __syncthreads();
    if (threadIdx.x == ROOT) {
        r = part[0];
        for (int w = 1; w < WARPS; ++w) {
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
// mbarriers and bulk copies (the TMA bodies of K1/K2 and K4)
// ---------------------------------------------------------------------------

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
// A block of a larger tensor (K1b's block mode, SRC 3): the block is stored
// contiguously as [n0, n1, n2] and its element (i0, i1, i2) is element
// base + i0*s0 + i1*s1 + i2 of the whole tensor, whose Philox word it takes.
// Any block of a placed leaf folds to three such dims (the wrapper folds it
// and refuses what does not).
struct Geo {
    long long n1, n2, s0, s1, base;
};

__device__ __forceinline__ unsigned long long geo_index(const Geo& geo, long long e) {
    const long long i2 = e % geo.n2, t = e / geo.n2;
    const long long i1 = t % geo.n1, i0 = t / geo.n1;
    return static_cast<unsigned long long>(geo.base + i0 * geo.s0 + i1 * geo.s1 + i2);
}

template <typename XT, typename QT, int SRC, bool WIRE, bool STATS, bool SMALL>
__device__ __forceinline__ void quantize_groups(const XT* __restrict__ x, long long groups,
                                                const uint32_t* __restrict__ bits,
                                                unsigned long long seed,
                                                unsigned long long c0, const Geo& geo,
                                                QT* __restrict__ q,
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
            if (SRC == 2 || SRC == 3) {
                // SRC 3: the group's four elements lie in one row of the
                // block, at a global index that is a multiple of four
                const uint64_t ctr = SRC == 2 ? c0 + static_cast<uint64_t>(gi)
                                              : (geo_index(geo, 4 * gi) >> 2);
                const Philox4 r = philox4x32_10(ctr, seed);
                bv[u][0] = r.v[0]; bv[u][1] = r.v[1]; bv[u][2] = r.v[2]; bv[u][3] = r.v[3];
            }
            if (gi < groups) {
                float qv[4];
                Sums t[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    qv[j] = quant_one<SRC, WIRE, STATS, SMALL>(xv[u][j], bv[u][j], g, acc,
                                                               t[j]);
                store4(q + 4 * gi, qv);
                const Sums grp = (t[0] + t[1]) + (t[2] + t[3]);
                half[u / 2] = (u % 2) ? half[u / 2] + grp : grp;
            }
        }
        if (STATS) acc.add(half[0] + half[1]);
    }
}

// The statistics' last stage, at the end of every K1/K2 block (WARPS warps,
// all of them calling it with their thread's row): the block's row goes to
// partials[blockIdx.x]; the block that takes the last ticket (an int
// counter, atomicAdd after a fence, no float atomic) folds every block's
// row in block order and writes the seven float32 statistics (count
// nonzero overflow abs_err_sum rel_err_sum abs_sum max_abs; the count is
// n), then sets the ticket back to 0 for the next launch.  Thread ROOT
// does the block's share: one with no stores of q outstanding makes the
// fence cheap.  So a call is one launch, and the same input gives the same
// bits on every run.  The launches of one ticket must not overlap: the
// port launches every quantizer on one stream (a second stream would need
// a ticket of its own).
template <int WARPS, int ROOT>
__device__ __forceinline__ void finish_stats(Row r, double* __restrict__ partials,
                                             float* __restrict__ stats,
                                             int* __restrict__ ticket, long long n) {
    __shared__ bool last;
    block_reduce_row<WARPS, ROOT>(r);
    if (threadIdx.x == ROOT) {
        write_row(partials + static_cast<long long>(blockIdx.x) * PART, r);
        __threadfence();                           // the row before the ticket
        last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();                               // every row after it
    Row f = {{0.0, 0.0, 0.0, 0.0, 0.0, 0.0}, 0.0f};
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += WARPS * 32) {
        const double* p = partials + static_cast<long long>(b) * PART;
#pragma unroll
        for (int k = 0; k < PART - 1; ++k) f.v[k] += __ldcg(p + k);
        f.mx = max_nan(f.mx, static_cast<float>(__ldcg(p + PART - 1)));
    }
    block_reduce_row<WARPS, ROOT>(f);
    if (threadIdx.x == ROOT) {
        stats[0] = static_cast<float>(n);
#pragma unroll
        for (int k = 1; k < PART - 1; ++k) stats[k] = static_cast<float>(f.v[k]);
        stats[6] = f.mx;
        *ticket = 0;
    }
}

// The grid-stride body: bits source 0 = round to nearest, 1 =
// bits operand, 2 = Philox in registers; element e takes word (ctr_base +
// e) % 4 of counter (ctr_base + e) / 4; 3 = Philox in registers for a block
// of a larger tensor, element e taking the word of its global index
// geo_index(geo, e).  QT is x's type (K1) or signed char (WIRE, K2).  Four
// blocks of 256 threads fit an SM (at most 64 registers a thread), so the
// grid of kernels/dps_quant.py runs in one wave.
template <typename XT, typename QT, int SRC, bool WIRE, bool STATS, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
quantize_kernel(const XT* __restrict__ x, long long n, const int* __restrict__ il,
                const int* __restrict__ fl, const uint32_t* __restrict__ bits,
                unsigned long long seed, unsigned long long ctr_base, Geo geo,
                QT* __restrict__ q, double* __restrict__ partials, float* __restrict__ stats,
                int* __restrict__ ticket) {
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
            quantize_groups<XT, QT, SRC, WIRE, STATS, true>(x, groups, bits, seed, c0, geo, q,
                                                            g, acc, t0, stride);
        else
            quantize_groups<XT, QT, SRC, WIRE, STATS, false>(x, groups, bits, seed, c0, geo, q,
                                                             g, acc, t0, stride);
    }
    // scalar path: everything when aligned access is not possible, else the
    // ragged tail of fewer than four elements
    for (long long e = (VEC ? 4 * groups : 0) + t0; e < n; e += stride) {
        uint32_t b = 0u;
        if (SRC == 1) b = bits[e];
        if (SRC == 2 || SRC == 3) {
            const unsigned long long c =
                SRC == 2 ? ctr_base + static_cast<unsigned long long>(e) : geo_index(geo, e);
            b = philox4x32_10(c >> 2, seed).v[c & 3];
        }
        Sums t;
        store1(q + e, quant_one<SRC, WIRE, STATS>(to_f32(x[e]), b, g, acc, t));
        if (STATS) acc.add(t);
    }

    if (STATS) finish_stats<THREADS / 32, 0>(to_row(acc), partials, stats, ticket, n);
}

// The TMA body, for q in x's type without a bits operand (K1b, or to
// nearest: the launches the plan gives it).  A block is Q_CONSUMERS
// consumer threads and one producer warp; a ring of `stages` stages in
// dynamic shared memory, each `span` elements of x, then the stages' full
// and empty mbarriers and each stage's item header.  The tensor is seen as the block's [n0, n1, n2] (a contiguous
// tensor: [1, 1, n]); its items are contiguous spans of its storage, cut by
// kernels/dps_quant.py's quant_plan:
//   rows == 0: spans of `span` elements inside each row of n2 (the last of
//              a row shorter), `per` items a row;
//   rows > 0:  `rows` whole rows of one [n1, n2] slab (the last of a slab
//              fewer), `per` items a slab.
// Block b takes items b, b + gridDim.x, ... (a fixed assignment, so the
// statistics' order is fixed too).
constexpr int Q_CONSUMERS = 256;
constexpr int Q_TMA_THREADS = Q_CONSUMERS + 32;
constexpr int Q_MAX_DYN_SMEM = 200 << 10;           // the most a plan may ask for

struct QItems {
    long long items, per;       // items; items a row (rows == 0) or a slab
    long long n1, n2;           // rows a slab, elements a row
    long long s0, s1, base;     // Philox: element (i0, i1, i2) is base + i0*s0 + i1*s1 + i2
    int span, rows, stages;     // elements a stage; rows an item (0: spans); stages
};

struct ItemHead {
    long long start;            // the item's first element in x and q
    unsigned long long ctr;     // the Philox counter of its first group of four
    int len;                    // its elements, a multiple of four
};

// Item i's header: two 64-bit divisions an item (its row or slab, and the
// row's place in the slab), worked out by the producer alone.
__device__ __forceinline__ ItemHead item_head(const QItems& it, long long i) {
    ItemHead h;
    long long i0, i1, off;
    if (it.rows == 0) {
        const long long row = i / it.per, k = i - row * it.per;
        i0 = row / it.n1;
        i1 = row - i0 * it.n1;
        off = k * it.span;
        h.start = row * it.n2 + off;
        h.len = static_cast<int>(min(static_cast<long long>(it.span), it.n2 - off));
    } else {
        i0 = i / it.per;
        i1 = (i - i0 * it.per) * it.rows;
        off = 0;
        h.start = (i0 * it.n1 + i1) * it.n2;
        h.len = static_cast<int>(min(static_cast<long long>(it.rows), it.n1 - i1) * it.n2);
    }
    h.ctr = static_cast<unsigned long long>(it.base + i0 * it.s0 + i1 * it.s1 + off) >> 2;
    return h;
}

// One element on the TMA body, as quant_one with fewer instructions (the
// consumers issue every one of them; at the placed step's sizes that, not
// the bytes, sets the time): the error terms in grid units, err = |v - yc|
// and ref = |yc| (a power of two scales them to quant_one's |q - x_ref| and
// |x_ref| exactly, so with SMALL the float sums are scaled once by 2^-FL,
// in double, at the block's end; a wider grid, whose sums in grid units
// could overflow, scales each term); the IEEE division on operands made
// nonzero, so no branch around it and no slow path for a zero (an element
// of 0, or one already on the grid); no lower clip of k (yc >= qmin and the
// bits' fraction >= 0 keep k >= qmin, and NaN passes either way).
struct Counts {
    unsigned int nz = 0u, over = 0u;
    float mx = 0.0f;
};

template <int SRC, bool STATS, bool SMALL>
__device__ __forceinline__ float quant_lean(float x, uint32_t bits, const Grid& g, Counts& c,
                                            Sums& t) {
    const float y = x * g.scale;
    const float yc = clamp_nan(y, g.qmin, g.qmax);
    const float r = yc + (SRC == 0 ? 0.5f
                                   : static_cast<float>(bits >> 8) * (1.0f / 16777216.0f));
    const float v = min_nan(SMALL ? floor_small(r) : floorf(r), g.qmax);
    if (STATS) {
        const float err = fabsf(v - yc), ref = fabsf(yc);
        const bool nz = ref > 0.0f;
        const bool over = (y > g.qmax) || (y < g.qmin);
        c.nz += nz ? 1u : 0u;
        c.over += over ? 1u : 0u;
        // an operand of 0 would send the whole warp down the division's
        // slow path; 0 / ref is +0, the select's value
        const bool div = nz && err > 0.0f;
        const float rel = __fdiv_rn(div ? err : 1.0f, div ? ref : 1.0f);
        t.abs_err = SMALL ? err : err * g.inv_scale;
        t.rel = div ? rel : 0.0f;
        t.abs_ref = SMALL ? ref : ref * g.inv_scale;
        c.mx = max_nan(c.mx, fabsf(x));
    }
    return v * g.inv_scale;
}

// The consumers.  Thread tid takes groups tid, tid + Q_CONSUMERS, ... of
// each item from shared memory and stores q with one 16-byte (fp32) or
// 8-byte (bf16) store a group, so a warp's store covers contiguous bytes.  Group j of an item lies in its row j / W at counter
// word j % W (W = n2 / 4 with whole rows, span / 4 otherwise: no wrap), so
// a thread's (row counter, word) steps by a constant with one carry: no
// division a group.  A group's float terms add in a pairwise tree, a
// thread's groups of an item in order, and the item's sums go to double
// once.
template <typename XT, int SRC, bool STATS, bool SMALL>
__device__ __forceinline__ void consume_items(const QItems& it, const unsigned char* data,
                                              long long stage_bytes, const uint64_t* full,
                                              uint64_t* empty, const ItemHead* head,
                                              unsigned long long seed, XT* __restrict__ q,
                                              const Grid& g, Counts& c, Acc& acc) {
    const int tid = threadIdx.x;
    const int W = it.rows ? static_cast<int>(it.n2 >> 2) : (it.span >> 2);
    const int r0 = tid / W, w0 = tid - r0 * W;
    const int dq = Q_CONSUMERS / W, dr = Q_CONSUMERS - dq * W;
    const unsigned long long s1 = static_cast<unsigned long long>(it.s1) >> 2;
    const unsigned long long dstep = static_cast<unsigned long long>(dq) * s1;
    int k = 0;
    for (long long i = blockIdx.x; i < it.items; i += gridDim.x, ++k) {
        const int s = k % it.stages;
        mbar_wait(smem_u32(full + s), (k / it.stages) & 1);
        const ItemHead h = head[s];
        const XT* xs = reinterpret_cast<const XT*>(data + s * stage_bytes);
        XT* qo = q + h.start;
        const int groups = h.len >> 2;
        unsigned long long rowc = h.ctr + static_cast<unsigned long long>(r0) * s1;
        int w = w0;
        Sums item;
        for (int j = tid; j < groups; j += Q_CONSUMERS) {
            float xv[4];
            uint32_t bv[4] = {0u, 0u, 0u, 0u};
            load4(xs + 4 * j, xv);
            if (SRC == 3) {
                const Philox4 r = philox4x32_10(rowc + static_cast<unsigned>(w), seed);
                bv[0] = r.v[0]; bv[1] = r.v[1]; bv[2] = r.v[2]; bv[3] = r.v[3];
            }
            float qv[4];
            Sums t[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                qv[e] = quant_lean<SRC, STATS, SMALL>(xv[e], bv[e], g, c, t[e]);
            store4(qo + 4 * j, qv);
            if (STATS) item = item + ((t[0] + t[1]) + (t[2] + t[3]));
            w += dr;
            rowc += dstep;
            if (w >= W) {
                w -= W;
                rowc += s1;
            }
        }
        if (STATS) acc.add(item);
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(smem_u32(empty + s));
    }
}

// SRC: 0 = round to nearest, 3 = Philox of the element's global index (a
// contiguous tensor's stream is the geometry [1, 1, n] at base ctr_base).
template <typename XT, int SRC, bool STATS>
__global__ void __launch_bounds__(Q_TMA_THREADS, 2)
quantize_tma_kernel(const XT* __restrict__ x, long long n, const int* __restrict__ il,
                    const int* __restrict__ fl, unsigned long long seed, QItems it,
                    XT* __restrict__ q, double* __restrict__ partials,
                    float* __restrict__ stats, int* __restrict__ ticket) {
    extern __shared__ __align__(128) unsigned char q_smem[];
    const long long stage_bytes = static_cast<long long>(it.span) * sizeof(XT);
    unsigned char* data = q_smem;
    uint64_t* full = reinterpret_cast<uint64_t*>(q_smem + it.stages * stage_bytes);
    uint64_t* empty = full + it.stages;
    ItemHead* head = reinterpret_cast<ItemHead*>(empty + it.stages);
    const int tid = threadIdx.x;

    if (tid == 0) {
        for (int s = 0; s < it.stages; ++s) {
            mbar_init(smem_u32(full + s), 1);
            mbar_init(smem_u32(empty + s), Q_CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    Acc acc;
    Counts c;
    float unit = 1.0f;                   // the value of the sums' unit (2^-FL)
    if (tid == Q_CONSUMERS) {
        // the producer: one thread writes each item's header beside its
        // stage and issues its bulk copy once the consumers have freed the
        // stage
        int k = 0;
        for (long long i = blockIdx.x; i < it.items; i += gridDim.x, ++k) {
            const ItemHead h = item_head(it, i);
            const int s = k % it.stages;
            if (k >= it.stages) mbar_wait(smem_u32(empty + s), ((k / it.stages) & 1) ^ 1);
            head[s] = h;
            const uint32_t bar = smem_u32(full + s);
            const uint32_t xb = static_cast<uint32_t>(h.len) * sizeof(XT);
            mbar_arrive_tx(bar, xb);
            bulk_load(smem_u32(data + s * stage_bytes), x + h.start, xb, bar);
        }
    } else if (tid < Q_CONSUMERS) {
        const int ilv = *il, flv = *fl;
        const Grid g = make_grid(ilv, flv);
        // the span 2^(IL-1+FL) <= 2^22 (uniform across the grid)
        if (ilv - 1 + flv <= 22) {
            unit = g.inv_scale;
            consume_items<XT, SRC, STATS, true>(it, data, stage_bytes, full, empty, head,
                                                seed, q, g, c, acc);
        } else
            consume_items<XT, SRC, STATS, false>(it, data, stage_bytes, full, empty, head,
                                                 seed, q, g, c, acc);
    }
    if (STATS) {
        Row r;
        r.v[0] = 0.0; r.v[1] = c.nz; r.v[2] = c.over;
        r.v[3] = acc.abs_err * unit; r.v[4] = acc.rel; r.v[5] = acc.abs_ref * unit;
        r.mx = c.mx;
        finish_stats<Q_TMA_THREADS / 32, Q_CONSUMERS>(r, partials, stats, ticket, n);
    }
}

// One call's operands, for the launchers below.
template <typename XT, typename QT>
struct QuantOps {
    const XT* x;
    long long n;
    const int *il, *fl;
    const uint32_t* bits;
    unsigned long long seed, ctr_base;
    QT* q;
    double* partials;
    float* stats;
    int* ticket;
};

template <typename XT, typename QT, int SRC, bool WIRE, bool STATS>
cudaError_t launch_quantize(const QuantOps<XT, QT>& o, const Geo& geo, bool vec, int nblocks,
                            cudaStream_t s) {
    if (vec)
        quantize_kernel<XT, QT, SRC, WIRE, STATS, true><<<nblocks, THREADS, 0, s>>>(
            o.x, o.n, o.il, o.fl, o.bits, o.seed, o.ctr_base, geo, o.q, o.partials, o.stats,
            o.ticket);
    else
        quantize_kernel<XT, QT, SRC, WIRE, STATS, false><<<nblocks, THREADS, 0, s>>>(
            o.x, o.n, o.il, o.fl, o.bits, o.seed, o.ctr_base, geo, o.q, o.partials, o.stats,
            o.ticket);
    return cudaSuccess;
}

template <typename XT, int SRC, bool STATS>
cudaError_t launch_quantize_tma(const QuantOps<XT, XT>& o, const QItems& it, int nblocks,
                                size_t smem, cudaStream_t s) {
    // set once to the most a plan may ask for, so that no later launch (one
    // captured into a CUDA graph included) needs the call
    static bool attr = false;
    if (!attr) {
        const cudaError_t err =
            cudaFuncSetAttribute(quantize_tma_kernel<XT, SRC, STATS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Q_MAX_DYN_SMEM);
        if (err != cudaSuccess) return err;
        attr = true;
    }
    quantize_tma_kernel<XT, SRC, STATS><<<nblocks, Q_TMA_THREADS, smem, s>>>(
        o.x, o.n, o.il, o.fl, o.seed, it, o.q, o.partials, o.stats, o.ticket);
    return cudaSuccess;
}

// The grid-stride body, sources 0-3.
template <typename XT, typename QT, bool WIRE>
cudaError_t dispatch_quantize(const QuantOps<XT, QT>& o, int src, bool stats, bool vec,
                              const Geo& geo, int nblocks, cudaStream_t s) {
#define DPS_Q(SRC, ST) return launch_quantize<XT, QT, SRC, WIRE, ST>(o, geo, vec, nblocks, s)
    if (src == 0) { if (stats) DPS_Q(0, true); else DPS_Q(0, false); }
    if (src == 1) { if (stats) DPS_Q(1, true); else DPS_Q(1, false); }
    if (src == 2) { if (stats) DPS_Q(2, true); else DPS_Q(2, false); }
    if (stats) DPS_Q(3, true); else DPS_Q(3, false);
#undef DPS_Q
}

// The TMA body: q in x's type, sources 0 and 3 (the caller maps 2 to 3).
template <typename XT>
cudaError_t dispatch_quantize_tma(const QuantOps<XT, XT>& o, int src, bool stats,
                                  const QItems& it, int nblocks, size_t smem, cudaStream_t s) {
#define DPS_T(SRC, ST) return launch_quantize_tma<XT, SRC, ST>(o, it, nblocks, smem, s)
    if (src == 0) { if (stats) DPS_T(0, true); else DPS_T(0, false); }
    if (stats) DPS_T(3, true); else DPS_T(3, false);
#undef DPS_T
}

// ---------------------------------------------------------------------------
// K3 / K3b
// ---------------------------------------------------------------------------

constexpr int G_MAX_GRID = 4 * THREADS;   // blocks a launch may have (the fold's prefix)
// blocks an SM (the launch bound, at most 64 registers a thread;
// kernels/dps_quant.py's group_plan sizes the grid by it) and groups of four
// a thread loads at once
constexpr int G_BPS = 4, G_U = 4;

constexpr int G_PART = PART + 1;    // a run's partial row: the seven columns, its group

// One element onto the wire as quant_one computes it (WIRE, any span, floorf),
// with the kept-element count, MASKED weighing the statistics and the byte by
// the mask `m` (1 keeps the element, 0 drops it), and the IEEE division of
// the relative error on operands made nonzero and no branch round it: an
// operand of 0 would send the whole warp down the division's slow path;
// 0 / ref is +0, the select's value, and an element whose abs_ref is not > 0
// (zero, or NaN) takes 0 either way.
template <int SRC, bool STATS, bool MASKED>
__device__ __forceinline__ float wire_one(float x, uint32_t bits, float m, const Grid& g,
                                          Acc& acc, Sums& t) {
    const float y = x * g.scale;
    const float yc = clamp_nan(y, g.qmin, g.qmax);
    const float r = yc + (SRC == 0 ? 0.5f
                                   : static_cast<float>(bits >> 8) * (1.0f / 16777216.0f));
    const float k = clamp_nan(floorf(r), g.qmin, g.qmax);
    const float v = clamp_nan(k, -128.0f, 127.0f);
    if (STATS) {
        const bool keep = !MASKED || m != 0.0f;
        const float x_ref = yc * g.inv_scale;
        const float abs_err = MASKED ? fabsf(v * g.inv_scale - x_ref) * m
                                     : fabsf(v * g.inv_scale - x_ref);
        const float abs_ref = MASKED ? fabsf(x_ref) * m : fabsf(x_ref);
        const bool nz = abs_ref > 0.0f;
        const bool over = (y > g.qmax) || (y < g.qmin) || k != v;
        acc.cnt += keep ? 1u : 0u;
        acc.nz += nz ? 1u : 0u;
        acc.over += (over && keep) ? 1u : 0u;
        const bool div = nz && abs_err > 0.0f;
        const float rel = __fdiv_rn(div ? abs_err : 1.0f, div ? abs_ref : 1.0f);
        t.abs_err = abs_err;
        t.rel = div ? rel : 0.0f;
        t.abs_ref = abs_ref;
        acc.mx = max_nan(acc.mx, MASKED ? fabsf(x) * m : fabsf(x));
    }
    return MASKED ? v * m : v;
}

// One batch of U groups of four of encode_groups, from group j0 of the
// piece on; FULL: all U lie inside it (no guard between the loads, so they
// issue back to back, and the U Philox blocks interleave).
template <typename XT, int SRC, bool STATS, bool MASKED, int U, bool FULL>
__device__ __forceinline__ void encode_batch(const XT* __restrict__ x,
                                             const uint32_t* __restrict__ bits,
                                             const float* __restrict__ mask,
                                             signed char* __restrict__ wire, long long e0,
                                             int j0, int ng, unsigned long long c0,
                                             unsigned long long gseed,
                                             const int* __restrict__ fmt_tab, int grp, Acc& acc) {
    float xv[U][4], mv[U][4];
    uint32_t bv[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int j = j0 + u * THREADS;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            xv[u][k] = 0.0f;
            mv[u][k] = 1.0f;
            bv[u][k] = 0u;
        }
        if (FULL || j < ng) {
            const long long e = e0 + 4ll * j;
            load4(x + e, xv[u]);
            if (SRC == 1) {
                const uint4 b = __ldcs(reinterpret_cast<const uint4*>(bits + e));
                bv[u][0] = b.x; bv[u][1] = b.y; bv[u][2] = b.z; bv[u][3] = b.w;
            }
            if (MASKED) load4(mask + e, mv[u]);
        }
    }
    // the format row and the Philox words while the loads are out (a
    // piece's first loads wait for neither, nor for its tile's group)
    const Grid g = make_grid(__ldg(fmt_tab + 2 * grp), __ldg(fmt_tab + 2 * grp + 1));
    if (SRC == 2) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = j0 + u * THREADS;
            if (FULL || j < ng) {
                const Philox4 r = philox4x32_10(c0 + static_cast<unsigned>(j), gseed);
                bv[u][0] = r.v[0]; bv[u][1] = r.v[1]; bv[u][2] = r.v[2]; bv[u][3] = r.v[3];
            }
        }
    }
    Sums sum;
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int j = j0 + u * THREADS;
        if (FULL || j < ng) {
            float wv[4];
            Sums t[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
                wv[k] = wire_one<SRC, STATS, MASKED>(xv[u][k], bv[u][k], mv[u][k], g, acc, t[k]);
            store4(wire + e0 + 4ll * j, wv);
            if (STATS) sum = sum + ((t[0] + t[1]) + (t[2] + t[3]));
        }
    }
    if (STATS) acc.add(sum);
}

// Groups of four elements [e0, e0 + 4 ng) of one piece, whose first group
// takes Philox counter c0 (SRC 2): thread tid takes groups tid, tid + 256,
// ..., U at a time with every load issued before the first is used, the
// counter of group j c0 + j (no division).  A batch's float terms add in
// float and go to double once.
template <typename XT, int SRC, bool STATS, bool MASKED>
__device__ __forceinline__ void encode_groups(const XT* __restrict__ x,
                                              const uint32_t* __restrict__ bits,
                                              const float* __restrict__ mask,
                                              signed char* __restrict__ wire, long long e0,
                                              int ng, unsigned long long c0,
                                              unsigned long long gseed,
                                              const int* __restrict__ fmt_tab, int grp, Acc& acc) {
    constexpr int U = G_U;
    int j0 = threadIdx.x;
    for (; j0 + (U - 1) * THREADS < ng; j0 += U * THREADS)
        encode_batch<XT, SRC, STATS, MASKED, U, true>(x, bits, mask, wire, e0, j0, ng, c0,
                                                      gseed, fmt_tab, grp, acc);
    if (j0 < ng)
        encode_batch<XT, SRC, STATS, MASKED, U, false>(x, bits, mask, wire, e0, j0, ng, c0,
                                                       gseed, fmt_tab, grp, acc);
}

// Elements [e0, e0 + len) of one tile one at a time (no 16-byte access, or a
// Philox stream off a counter boundary); element i takes word (c + i) % 4 of
// counter (c + i) / 4.
template <typename XT, int SRC, bool STATS, bool MASKED>
__device__ __forceinline__ void encode_elements(const XT* __restrict__ x,
                                                const uint32_t* __restrict__ bits,
                                                const float* __restrict__ mask,
                                                signed char* __restrict__ wire, long long e0,
                                                int len, unsigned long long c,
                                                unsigned long long gseed,
                                                const int* __restrict__ fmt_tab, int grp, Acc& acc) {
    const Grid g = make_grid(__ldg(fmt_tab + 2 * grp), __ldg(fmt_tab + 2 * grp + 1));
    for (int i = threadIdx.x; i < len; i += THREADS) {
        const long long e = e0 + i;
        uint32_t b = 0u;
        if (SRC == 1) b = bits[e];
        if (SRC == 2) {
            const unsigned long long ci = c + static_cast<unsigned long long>(i);
            b = philox4x32_10(ci >> 2, gseed).v[ci & 3];
        }
        Sums t;
        store1(wire + e, wire_one<SRC, STATS, MASKED>(to_f32(x[e]), b,
                                                      MASKED ? mask[e] : 1.0f, g, acc, t));
        if (STATS) acc.add(t);
    }
}

// The statistics' scratch of one launch (the wrapper sizes it by
// kernels/dps_quant.py's group_plan): a run's partial row a slot, one slot a
// piece a block may take (group_slots); then int32 runs a block, and the
// fold's order of slots and their groups.
struct GroupScratch {
    double* rows;
    int *runs, *ord, *ogid;
};

__device__ __forceinline__ GroupScratch group_scratch(double* base, long long slots, int grid) {
    GroupScratch s;
    s.rows = base;
    s.runs = reinterpret_cast<int*>(base + slots * G_PART);
    s.ord = s.runs + grid;
    s.ogid = s.ord + slots;
    return s;
}

// A launch's items (kernels/dps_quant.py's group_plan): with per > 1, item i
// is piece i % per of tile i / per (`piece` elements, the last of a tile
// shorter); with per == 1, item i is tiles [i * run, (i + 1) * run) whole
// (the last item fewer).  Block b takes items b, b + grid, ... (as K4's and
// K1's TMA bodies do), so the card sweeps the buffer front to back, and a
// block's pieces come in a fixed order.
struct GItems {
    long long tiles, quantum, items, piece;
    int per, run;
};

struct Piece {
    long long i, t, off;        // its item; its tile and first element there
    int k, r, len;              // piece of the tile (per > 1), tile of the item
                                // (per == 1); elements, 0 past the end
};

__device__ __forceinline__ void piece_len(const GItems& it, Piece& p) {
    p.len = 0;
    if (p.i >= it.items) return;
    p.off = it.per > 1 ? p.k * it.piece : 0;
    p.len = static_cast<int>(it.per > 1 ? min(it.piece, it.quantum - p.off) : it.quantum);
}

// The block's first piece: its item blockIdx.x (one division a block).
__device__ __forceinline__ Piece first_piece(const GItems& it) {
    Piece p;
    p.i = blockIdx.x;
    p.r = 0;
    p.t = it.per > 1 ? p.i / it.per : p.i * it.run;
    p.k = static_cast<int>(it.per > 1 ? p.i - p.t * it.per : 0);
    piece_len(it, p);
    return p;
}

// The piece after p in the block's order: the item's next tile, or item i +
// grid, whose piece and tile step by grid % per and grid / per with one
// carry (dk, dt: no division a piece).
__device__ __forceinline__ Piece next_piece(const GItems& it, Piece p, int dk, long long dt) {
    if (it.per == 1 && p.r + 1 < it.run && p.t + 1 < it.tiles) {
        ++p.r;
        ++p.t;
    } else {
        p.i += gridDim.x;
        p.r = 0;
        if (it.per > 1) {
            p.k += dk;
            p.t += dt;
            if (p.k >= it.per) {
                p.k -= it.per;
                ++p.t;
            }
        } else {
            p.t = p.i * it.run;
        }
    }
    piece_len(it, p);
    return p;
}

// Block b's first slot: a slot a piece of the items before its own (items
// b' < b take b' items of every grid, and one more below items % grid).
__device__ __forceinline__ long long group_slots(const GItems& it, int b) {
    const long long grid = gridDim.x;
    const long long before = b * (it.items / grid) + min(static_cast<long long>(b), it.items % grid);
    return before * (it.per > 1 ? 1 : it.run);
}

// The block's running row of its current run of one group -> its slot;
// every thread calls it (the group changes at the same tile for all).
__device__ __forceinline__ void flush_run(Acc& acc, int grp, double* dst) {
    Row r = to_row(acc);
    block_reduce_row(r);
    if (threadIdx.x == 0) {
        write_row(dst, r);
        dst[PART] = grp;
    }
    acc = Acc();
    __syncthreads();                     // block_reduce_row's shared rows are reused
}

// An exclusive prefix of v[0, n) (n <= G_MAX_GRID = 4 * THREADS) into
// pre[0, n]; every thread of the block calls it.
__device__ __forceinline__ void block_prefix(const int* __restrict__ v, int n, int* pre) {
    __shared__ int warp_sum[THREADS / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int mine[4], sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int i = 4 * tid + k;
        mine[k] = i < n ? __ldcg(v + i) : 0;
        sum += mine[k];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    int ex = before + incl - sum;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int i = 4 * tid + k;
        if (i < n) pre[i] = ex;
        ex += mine[k];
    }
    if (tid == THREADS - 1) pre[n] = ex;          // the total
    __syncthreads();
}

// The statistics' last stage, at the end of every block of a launch with
// them: the block writes its run count; the block that takes the last ticket
// (an int counter, atomicAdd after a fence; no other atomic) folds every
// run's row into stats[G, 7] in a fixed order (the blocks' runs in block
// order): counts and sums in double, the max by max_nan, a group with no
// run 0; then sets the ticket back to 0.  A group's runs are consecutive
// but where the tile map repeats it further on (a wire layout's tail reads
// row 0), so the thread of a group's first run adds every later run of the
// group as well: O(runs) a group, and the runs are a few a block.
__device__ void group_fold(const GroupScratch& s, int runs, const GItems& it, int groups,
                           float* __restrict__ stats, int* __restrict__ ticket) {
    __shared__ bool last;
    __shared__ int pre[G_MAX_GRID + 1];
    const int tid = threadIdx.x, grid = static_cast<int>(gridDim.x);
    if (tid == 0) {
        s.runs[blockIdx.x] = runs;
        __threadfence();                           // the rows and the count before the ticket
        last = atomicAdd(ticket, 1) == grid - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();                               // every block's rows after it
    for (long long k = tid; k < static_cast<long long>(groups) * PART; k += THREADS)
        stats[k] = 0.0f;
    block_prefix(s.runs, grid, pre);
    const int S = pre[grid];
    // run i in item order: block b = the last with pre[b] <= i, its run i - pre[b]
    for (int i = tid; i < S; i += THREADS) {
        int lo = 0, hi = grid - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (pre[mid] <= i) lo = mid; else hi = mid - 1;
        }
        const long long slot = group_slots(it, lo) + (i - pre[lo]);
        s.ord[i] = static_cast<int>(slot);
        s.ogid[i] = static_cast<int>(__ldcg(s.rows + slot * G_PART + PART));
    }
    __syncthreads();
    for (int i = tid; i < S; i += THREADS) {
        const int grp = s.ogid[i];
        bool first = true;                         // no earlier run of the group
        for (int j = i - 1; j >= 0 && first; --j) first = s.ogid[j] != grp;
        if (!first) continue;
        Row f = {{0.0, 0.0, 0.0, 0.0, 0.0, 0.0}, 0.0f};
        for (int j = i; j < S; ++j) {
            if (s.ogid[j] != grp) continue;
            const double* p = s.rows + static_cast<long long>(s.ord[j]) * G_PART;
#pragma unroll
            for (int k = 0; k < PART - 1; ++k) f.v[k] += __ldcg(p + k);
            f.mx = max_nan(f.mx, static_cast<float>(__ldcg(p + PART - 1)));
        }
        float* o = stats + static_cast<long long>(grp) * PART;
#pragma unroll
        for (int k = 0; k < PART - 1; ++k) o[k] = static_cast<float>(f.v[k]);
        o[PART - 1] = f.mx;
    }
    if (tid == 0) *ticket = 0;
}

// Element o of tile t lies at position t * quantum + o of the buffer and at
// aligned position start + t * quantum + o.  Block b takes items b, b + grid,
// ... (GItems), each piece with one format, one group and (SRC 2) one
// counter run.  SRC 2 (K3b): group g's stream is keyed on
// fold_seed(seed, group_base + g) and counts from goff[g], the group's
// aligned offset.  MASKED: `mask` is not null.  VEC: the quantum and the
// pieces are multiples of four and the buffers 16-byte aligned (the wrapper
// checked); a Philox piece takes the 16-byte path where its counters fall
// on a boundary of four (uniform in the tile).
template <typename XT, int SRC, bool STATS, bool MASKED, bool VEC>
__global__ void __launch_bounds__(THREADS, G_BPS)
group_wire_encode_kernel(const XT* __restrict__ x, const int* __restrict__ fmt_tab,
                         const int* __restrict__ tile_group, const uint32_t* __restrict__ bits,
                         const float* __restrict__ mask, unsigned long long seed,
                         const long long* __restrict__ goff, long long start,
                         long long group_base, signed char* __restrict__ wire, GItems it,
                         int groups, double* __restrict__ scratch, float* __restrict__ stats,
                         int* __restrict__ ticket) {
    const long long quantum = it.quantum;
    GroupScratch gs = {};
    if (STATS)
        gs = group_scratch(scratch, it.items * (it.per > 1 ? 1 : it.run),
                           static_cast<int>(gridDim.x));
    const long long slot0 = STATS ? group_slots(it, blockIdx.x) : 0;
    Acc acc;
    unsigned long long gseed = 0ull;
    long long gofs = 0;
    int cur = -1, runs = 0;
    // the tile map read one piece ahead; the format row is read after a
    // batch's loads are out, and a piece's group is waited for only where
    // the statistics or the Philox key need it
    const int dk = static_cast<int>(gridDim.x % it.per);
    const long long dt = gridDim.x / it.per;
    Piece p0 = first_piece(it);
    int g0 = p0.len ? __ldg(tile_group + p0.t) : 0;
    while (p0.len) {
        const Piece p1 = next_piece(it, p0, dk, dt);
        const int g1 = p1.len ? __ldg(tile_group + p1.t) : 0;
        if ((STATS || SRC == 2) && g0 != cur) {
            if (STATS && cur >= 0) flush_run(acc, cur, gs.rows + (slot0 + runs++) * G_PART);
            cur = g0;
            if (SRC == 2) {
                gseed = fold_seed(seed, static_cast<unsigned long long>(group_base + g0));
                gofs = __ldg(goff + g0);
            }
        }
        const long long e = p0.t * quantum + p0.off;
        // the Philox position of the piece's first element in its group
        const unsigned long long c =
            SRC == 2 ? static_cast<unsigned long long>(start + e - gofs) : 0ull;
        if (VEC && (SRC != 2 || (c & 3) == 0))
            encode_groups<XT, SRC, STATS, MASKED>(x, bits, mask, wire, e, p0.len >> 2, c >> 2,
                                                  gseed, fmt_tab, g0, acc);
        else
            encode_elements<XT, SRC, STATS, MASKED>(x, bits, mask, wire, e, p0.len, c, gseed,
                                                    fmt_tab, g0, acc);
        p0 = p1;
        g0 = g1;
    }
    if (STATS) {
        if (cur >= 0) flush_run(acc, cur, gs.rows + (slot0 + runs++) * G_PART);
        group_fold(gs, runs, it, groups, stats, ticket);
    }
}

// One launch's operands.
template <typename XT>
struct EncodeOps {
    const XT* x;
    const int *fmt_tab, *tile_group;
    const uint32_t* bits;
    const float* mask;
    unsigned long long seed;
    const long long* goff;
    long long start, group_base;
    signed char* wire;
    GItems it;
    int groups;
    double* scratch;
    float* stats;
    int* ticket;
};

template <typename XT, int SRC, bool STATS, bool MASKED>
void launch_encode(const EncodeOps<XT>& o, bool vec, int nblocks, cudaStream_t s) {
    if (vec)
        group_wire_encode_kernel<XT, SRC, STATS, MASKED, true><<<nblocks, THREADS, 0, s>>>(
            o.x, o.fmt_tab, o.tile_group, o.bits, o.mask, o.seed, o.goff, o.start,
            o.group_base, o.wire, o.it, o.groups, o.scratch, o.stats, o.ticket);
    else
        group_wire_encode_kernel<XT, SRC, STATS, MASKED, false><<<nblocks, THREADS, 0, s>>>(
            o.x, o.fmt_tab, o.tile_group, o.bits, o.mask, o.seed, o.goff, o.start,
            o.group_base, o.wire, o.it, o.groups, o.scratch, o.stats, o.ticket);
}

template <typename XT>
void dispatch_encode(const EncodeOps<XT>& o, int src, bool stats, bool masked, bool vec,
                     int nblocks, cudaStream_t s) {
#define DPS_E(SRC, ST, MK) launch_encode<XT, SRC, ST, MK>(o, vec, nblocks, s)
#define DPS_E_SRC(SRC)                                          \
    if (stats) { if (masked) DPS_E(SRC, true, true); else DPS_E(SRC, true, false); } \
    else { if (masked) DPS_E(SRC, false, true); else DPS_E(SRC, false, false); }
    if (src == 0) { DPS_E_SRC(0) }
    else if (src == 1) { DPS_E_SRC(1) }
    else { DPS_E_SRC(2) }
#undef DPS_E_SRC
#undef DPS_E
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
// `partials` (double [nblocks, 7]), `stats` (float [7]) and `ticket` (one
// int32, 0 between launches; see finish_stats) null means no statistics.
// `body` 0 is the grid-stride body: `vec` says the caller checked the
// alignment of x, q and bits (and ctr_base % 4 == 0 under Philox), and the
// caller sizes the grid (`nblocks`) as a function of n and of
// dps_quant_groups_per_thread(stats) alone.  `body` 1 is the TMA body (q in
// x's type, src 0 or 2), its items cut by `span` and `rows`, `stages`
// stages, `nblocks` blocks (the plan of kernels/dps_quant.py; the entry
// refuses what the body or a bulk copy cannot take).  Either way the statistics' summation order depends on the plan
// alone.  One launch a call; launches on `stream`, does not synchronise,
// returns cudaGetLastError().
// Groups of four elements a K1/K2 thread of the grid-stride body takes per
// iteration: Q_UNROLL without statistics, one with them.
extern "C" int dps_quant_groups_per_thread(int stats) { return stats ? 1 : Q_UNROLL; }

namespace {

// What the TMA body needs of a launch: q in x's type, no bits operand,
// 16-byte bulk copies of every item of x (the pointer, the span and a row
// 16-byte multiples), q aligned to its group's store, Philox counters four
// elements apart, the items inside the ring's stages.
bool tma_ok(const void* x, int xb, const void* q, int wire, long long n, const Geo& geo,
            int src, int span, int rows, int stages, long long smem) {
    const auto off = [](const void* p, int a) { return reinterpret_cast<uintptr_t>(p) % a; };
    return !wire && src != 1 && n > 0 && span > 0 && stages > 0 && rows >= 0 &&
           span % 4 == 0 && (static_cast<long long>(span) * xb) % 16 == 0 &&
           (geo.n2 * xb) % 16 == 0 && n % (geo.n1 * geo.n2) == 0 &&
           (rows == 0 || static_cast<long long>(rows) * geo.n2 <= span) && off(x, 16) == 0 &&
           off(q, 4 * xb) == 0 &&
           (src == 0 || (geo.base % 4 == 0 && geo.s0 % 4 == 0 && geo.s1 % 4 == 0)) &&
           smem <= Q_MAX_DYN_SMEM;
}

template <typename XT, typename QT, bool WIRE>
cudaError_t run_quantize(const QuantOps<XT, QT>& o, int src, bool stats, bool vec,
                         const Geo& geo, const QItems* it, int nblocks, size_t smem,
                         cudaStream_t s) {
    if constexpr (!WIRE) {
        if (it != nullptr) return dispatch_quantize_tma<XT>(o, src, stats, *it, nblocks, smem, s);
    }
    return dispatch_quantize<XT, QT, WIRE>(o, src, stats, vec, geo, nblocks, s);
}

int quantize_entry(const void* x, int x_is_bf16, long long n, const void* il, const void* fl,
                   const void* bits, int src, unsigned long long seed,
                   unsigned long long ctr_base, const Geo& geo, void* q, int wire,
                   void* partials, void* stats, void* ticket, int nblocks, int body, int vec,
                   int span, int rows, int stages, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool emit = partials != nullptr && stats != nullptr && ticket != nullptr;
    if (src < 0 || src > 3 || nblocks < 1 || body < 0 || body > 1 ||
        (src == 1 && bits == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 0 && !emit) return static_cast<int>(cudaGetLastError());
    const int xb = x_is_bf16 ? 2 : 4;
    // the TMA body's view: the block's [n0, n1, n2], a contiguous tensor's
    // [1, 1, n] with its stream from ctr_base
    QItems it = {};
    const long long smem = static_cast<long long>(stages) * (static_cast<long long>(span) * xb + 40);
    if (body == 1) {
        const Geo g = src == 3 ? geo : Geo{1, n, 0, 0, static_cast<long long>(ctr_base)};
        if (!tma_ok(x, xb, q, wire, n, g, src, span, rows, stages, smem))
            return static_cast<int>(cudaErrorInvalidValue);
        it.n1 = g.n1;
        it.n2 = g.n2;
        it.s0 = g.s0;
        it.s1 = g.s1;
        it.base = g.base;
        it.span = span;
        it.rows = rows;
        it.stages = stages;
        it.per = rows == 0 ? (it.n2 + span - 1) / span : (it.n1 + rows - 1) / rows;
        it.items = n / (rows == 0 ? it.n2 : it.n1 * it.n2) * it.per;
        if (src == 2) src = 3;
    }
    const QItems* itp = body == 1 ? &it : nullptr;
    const int* ilp = static_cast<const int*>(il);
    const int* flp = static_cast<const int*>(fl);
    const uint32_t* bp = static_cast<const uint32_t*>(bits);
    double* pp = emit ? static_cast<double*>(partials) : nullptr;
    float* sp = emit ? static_cast<float*>(stats) : nullptr;
    int* tp = emit ? static_cast<int*>(ticket) : nullptr;
    const long long nn = n > 0 ? n : 0;
    cudaError_t err;
    if (x_is_bf16) {
        const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
        if (wire) {
            const QuantOps<__nv_bfloat16, signed char> o = {
                xp, nn, ilp, flp, bp, seed, ctr_base, static_cast<signed char*>(q), pp, sp, tp};
            err = run_quantize<__nv_bfloat16, signed char, true>(o, src, emit, vec != 0, geo,
                                                                 itp, nblocks, smem, s);
        } else {
            const QuantOps<__nv_bfloat16, __nv_bfloat16> o = {
                xp, nn, ilp, flp, bp, seed, ctr_base, static_cast<__nv_bfloat16*>(q), pp, sp, tp};
            err = run_quantize<__nv_bfloat16, __nv_bfloat16, false>(o, src, emit, vec != 0, geo,
                                                                    itp, nblocks, smem, s);
        }
    } else {
        const float* xp = static_cast<const float*>(x);
        if (wire) {
            const QuantOps<float, signed char> o = {
                xp, nn, ilp, flp, bp, seed, ctr_base, static_cast<signed char*>(q), pp, sp, tp};
            err = run_quantize<float, signed char, true>(o, src, emit, vec != 0, geo, itp,
                                                         nblocks, smem, s);
        } else {
            const QuantOps<float, float> o = {
                xp, nn, ilp, flp, bp, seed, ctr_base, static_cast<float*>(q), pp, sp, tp};
            err = run_quantize<float, float, false>(o, src, emit, vec != 0, geo, itp, nblocks,
                                                    smem, s);
        }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dps_quantize(const void* x, int x_is_bf16, long long n, const void* il,
                            const void* fl, const void* bits, int src,
                            unsigned long long seed, unsigned long long ctr_base, void* q,
                            int wire, void* partials, void* stats, void* ticket, int nblocks,
                            int body, int vec, int span, int rows, int stages, void* stream) {
    if (src > 2) return static_cast<int>(cudaErrorInvalidValue);
    const Geo none = {1, 1, 0, 0, 0};
    return quantize_entry(x, x_is_bf16, n, il, fl, bits, src, seed, ctr_base, none, q, wire,
                          partials, stats, ticket, nblocks, body, vec, span, rows, stages,
                          stream);
}

// K1b / K2b in block mode: x is a block of a larger tensor, stored
// contiguously as [n / (n1 * n2), n1, n2]; its element (i0, i1, i2) takes
// the Philox word of element base + i0*s0 + i1*s1 + i2 of the whole tensor,
// so a rank's rounding of its block of a placed leaf is the rounding the
// whole leaf gets there.  `vec` also says n2, s0, s1 and base are multiples
// of four.  Otherwise as dps_quantize with src 2.
extern "C" int dps_quantize_block(const void* x, int x_is_bf16, long long n, const void* il,
                                  const void* fl, unsigned long long seed, long long n1,
                                  long long n2, long long s0, long long s1, long long base,
                                  void* q, int wire, void* partials, void* stats, void* ticket,
                                  int nblocks, int body, int vec, int span, int rows,
                                  int stages, void* stream) {
    if (n1 < 1 || n2 < 1 || base < 0) return static_cast<int>(cudaErrorInvalidValue);
    const Geo geo = {n1, n2, s0, s1, base};
    return quantize_entry(x, x_is_bf16, n, il, fl, nullptr, 3, seed, 0, geo, q, wire,
                          partials, stats, ticket, nblocks, body, vec, span, rows, stages,
                          stream);
}

// K3 / K3b.  All pointers are device pointers.  `src`: 0 = round to
// nearest, 1 = the `bits` operand, 2 = Philox keyed per group (`seed`,
// `goff` int64 [G], `start`, `group_base`; see group_wire_encode_kernel).
// `mask` null means every element counts.  `partials` (the scratch
// group_plan sizes), `stats` (float [G, 7]) and `ticket` (one int32, 0
// between launches; see group_fold) null means no statistics.  The items
// (GItems: `per` pieces of `piece` elements a tile, or `run` whole tiles an
// item) on `nblocks` blocks, as kernels/dps_quant.py's group_plan gives
// them; `vec` says the caller checked that the quantum and the pieces
// divide by four and the buffers are 16-byte aligned.  One launch a call;
// launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int dps_group_wire_encode(const void* x, int x_is_bf16, const void* fmt_tab,
                                     const void* tile_group, const void* bits,
                                     const void* mask, int src, unsigned long long seed,
                                     const void* goff, long long start, long long group_base,
                                     void* wire, void* partials, void* stats, void* ticket,
                                     long long tiles, long long quantum, int groups,
                                     int nblocks, long long piece, int per, int run, int vec,
                                     void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool emit = partials != nullptr && stats != nullptr && ticket != nullptr;
    if (src < 0 || src > 2 || (src == 1 && bits == nullptr) || (src == 2 && goff == nullptr) ||
        tiles < 0 || quantum < 1 || groups < 0 || per < 1 || run < 1 || piece < 1 ||
        (per > 1 && (run != 1 || piece * (per - 1) >= quantum || piece * per < quantum)) ||
        (per == 1 && piece != quantum) || (vec && (piece % 4 || quantum % 4)))
        return static_cast<int>(cudaErrorInvalidValue);
    const GItems it = {tiles, quantum, per > 1 ? tiles * per : (tiles + run - 1) / run, piece,
                       per, run};
    if (nblocks < 1 || nblocks > G_MAX_GRID ||
        (it.items > 0 ? nblocks > it.items : nblocks != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    if (it.items == 0 && !emit) return static_cast<int>(cudaGetLastError());
    if (x_is_bf16) {
        const EncodeOps<__nv_bfloat16> o = {
            static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(fmt_tab),
            static_cast<const int*>(tile_group), static_cast<const uint32_t*>(bits),
            static_cast<const float*>(mask), seed, static_cast<const long long*>(goff), start,
            group_base, static_cast<signed char*>(wire), it, groups,
            emit ? static_cast<double*>(partials) : nullptr,
            emit ? static_cast<float*>(stats) : nullptr, emit ? static_cast<int*>(ticket) : nullptr};
        dispatch_encode<__nv_bfloat16>(o, src, emit, mask != nullptr, vec != 0, nblocks, s);
    } else {
        const EncodeOps<float> o = {
            static_cast<const float*>(x), static_cast<const int*>(fmt_tab),
            static_cast<const int*>(tile_group), static_cast<const uint32_t*>(bits),
            static_cast<const float*>(mask), seed, static_cast<const long long*>(goff), start,
            group_base, static_cast<signed char*>(wire), it, groups,
            emit ? static_cast<double*>(partials) : nullptr,
            emit ? static_cast<float*>(stats) : nullptr, emit ? static_cast<int*>(ticket) : nullptr};
        dispatch_encode<float>(o, src, emit, mask != nullptr, vec != 0, nblocks, s);
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
