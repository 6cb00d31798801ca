// Paged decode attention over an int8 (or fp32) KV page pool, for Hopper
// (sm_90a): split-KV with a fixed-order merge.
//
// Replaces the TPU kernel `_paged_attn_kernel` of
// src/repro/kernels/paged_attn.py (entry `paged_attn_pallas`, pallas_call at
// :157): one query token per batch row attends over that row's pages.  A page
// is found through the page table, its int8 grid integers count in units of
// 2^-FL of that page, the scores of the query heads that share a KV head are
// scaled and masked at the row's length, and the softmax runs over the row.
// The fp32 cache never exists in device memory.
//
// Bound on this card: a row of length n reads n·KV·Dh bytes of K and of V and
// does 4·n·H·Dh fp32 operations, about G = H/KV operations a byte, so bytes
// bound the work; at the serving shape (8 rows of at most 577 tokens, 3.4 MB
// of K/V, a bytes bound near 1 µs) what bounds a call is latency: launches
// and the dependent trips page table -> pages.  At a long context (8 rows of
// 4,096 tokens, 67 MB, a bytes bound of 20 µs) it is the staging and the fp32
// arithmetic per byte.  The earlier design, one block per (row, KV head)
// walking its row in 64-token chunks, paid a chunk's latency serially and
// the longest row set the time.  Measured on an H100 at 700 W (kernel_ab.py,
// both designs replayed from CUDA graphs in one run, L2 flushed): 0.018 ms
// at the serving shape against the earlier 0.115 ms, 0.056-0.059 ms at the
// long context (35 % of its bound) against 0.734 ms.  In the same run a
// merge fused into each row's last split block (a self-resetting ticket)
// took 0.019 and 0.143 ms, the merge serialised behind that block, and a
// tensor-core body (int8 mma on digit planes) 0.023 and 0.090 ms: the two
// launches and the fp32 FMA body below are kept.
//
// The design: a call is two launches.
//   1. The split kernel.  A row's pages are cut into splits of `split_pages`
//      pages (kernels/paged_attn.py picks it: 128 tokens of int8); a work
//      item is one split of one (row, KV head).  As many blocks as fit on
//      the card at once each walk their items, and each item's K and V are
//      copied into shared memory (16-byte cp.async, int8 staged as int8)
//      while the block computes the item before it.  An item whose split
//      starts at or past its row's length is skipped.  The item's (m, l,
//      acc[G, Dh]) go to a workspace of B·KV·S_max·G·(Dh + 2) floats.
//   2. The merge kernel: for each (row, KV head) only the row's used splits,
//      m = max m_s, l = Σ l_s·e^(m_s - m), out = Σ acc_s·e^(m_s - m) /
//      max(l, 1e-30), the sums taken in a fixed order.  A row of length 0
//      comes out exactly 0.
// No float atomics: the same input gives the same bits on every run.  Plain
// fp32 FMA, no tensor cores, no TF32.  The wrapper's launch counter counts
// calls; a call is these two launches.

#include "common.cuh"

namespace {

constexpr int ATT_THREADS = 128;
constexpr int TP = 64;                          // tokens scored at once
constexpr int NS = ATT_THREADS / TP;            // slices of a row's channels
// finite, as in the reference: exp(NEG_INF - m) underflows to exactly 0
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// wait until at most one committed group of this thread is still in flight
__device__ __forceinline__ void cp_async_wait_prev() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four int8 grid integers (one 32-bit word) as exact floats without the
// quarter-rate int -> float conversion: each byte, offset by 128, becomes the
// low byte of the float 2^23 + byte, and one add takes 2^23 + 128 away.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* o) {
    w ^= 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        o[b] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + b)) - 8388736.0f;
}

// W consecutive elements from shared memory as floats: a 16-byte chunk when
// VEC (16 int8 or 4 fp32), else one element.
template <typename T, bool VEC>
struct Chunk {
    static constexpr int W = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
};

template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk(const T* p, float* o) {
    if constexpr (!VEC) {
        o[0] = static_cast<float>(p[0]);
    } else if constexpr (sizeof(T) == 1) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        i8x4_to_f32(v.x, o);
        i8x4_to_f32(v.y, o + 4);
        i8x4_to_f32(v.z, o + 8);
        i8x4_to_f32(v.w, o + 12);
    } else {
        const float4 v = *reinterpret_cast<const float4*>(p);
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    }
}

// V4 consecutive values of V (four when VEC, else one) as floats
template <typename T, bool VEC>
__device__ __forceinline__ void load_v(const T* p, float* o) {
    if constexpr (!VEC) {
        o[0] = static_cast<float>(p[0]);
    } else if constexpr (sizeof(T) == 1) {
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), o);
    } else {
        const float4 v = *reinterpret_cast<const float4*>(p);
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    }
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ __forceinline__ size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

// Value pass geometry: a thread takes V4 channels of NQ token slices; the
// slices' partial sums meet in shared memory.
__host__ __device__ __forceinline__ int value_slices(int Dh, bool vec) {
    const int cv = vec ? Dh / 4 : Dh;
    return cv >= ATT_THREADS ? 1 : ATT_THREADS / cv;
}

// Shared memory of a split block: two stage buffers, so that one split's
// copies are in flight while the block computes the previous one, then the
// scores and the score slices' sums.  A buffer holds the split's pool
// offsets, queries, FL rows and page ids, its tokens' page slots, and the
// int8/fp32 V and K slices on 16-byte boundaries; K is dead once the scores
// exist, and the value slices' partial sums reuse its room.
struct SplitSmem {
    size_t off, q, fl, phys, tpg, v, k, buf;      // offsets within a buffer
    size_t s, sp, total;                          // after both buffers
    __host__ __device__ SplitSmem(int G, int Dh, int TS, int SP, int NQ, size_t esize) {
        off = 0;
        q = align16(off + sizeof(long long) * static_cast<size_t>(TS));
        fl = align16(q + sizeof(float) * static_cast<size_t>(G) * Dh);
        phys = fl + sizeof(int) * 2 * static_cast<size_t>(SP);
        tpg = phys + sizeof(int) * static_cast<size_t>(SP);
        v = align16(tpg + sizeof(int) * static_cast<size_t>(TS));
        k = v + align16(esize * static_cast<size_t>(TS) * Dh);
        buf = k + align16(max_sz(esize * static_cast<size_t>(TS) * Dh,
                                 sizeof(float) * static_cast<size_t>(NQ) * G * Dh));
        s = 2 * buf;
        sp = s + sizeof(float) * static_cast<size_t>(G) * TS;
        total = sp + sizeof(float) * static_cast<size_t>(NS) * G * TS;
    }
};

// One split of one (row, KV head): work item i = (b·KV + kvh)·S_max + s.
struct Item {
    int b, kvh, s, len, ntok, npg;
};

// The first item at or after `i`, stepping by `step`, whose split starts
// before its row's length.  Uniform across the block.
__device__ __forceinline__ bool next_item(long long& i, long long n_items, long long step,
                                          const int* __restrict__ lens, int KV, int S_max,
                                          int P, int ps, int SP, Item& it) {
    const int TS = SP * ps;
    for (; i < n_items; i += step) {
        const long long r = i / S_max;
        it.s = static_cast<int>(i - r * S_max);
        it.kvh = static_cast<int>(r % KV);
        it.b = static_cast<int>(r / KV);
        it.len = min(max(lens[it.b], 0), P * ps);
        const int t0 = it.s * TS;
        if (t0 < it.len) {
            it.ntok = min(TS, it.len - t0);
            it.npg = (it.ntok + ps - 1) / ps;
            return true;
        }
    }
    return false;
}

// The persistent split kernel.  Each block walks the items i = blockIdx.x,
// blockIdx.x + gridDim.x, ... that hold live tokens.  An item's page ids are
// loaded into a register one item ahead (they arrive while the block
// computes); from them the block lays out the token offsets and issues the
// item's FL rows, queries, K and V as cp.async copies (16 bytes, int8 staged
// as int8), then computes the item before it: a split's copies are in flight
// while the block computes its predecessor.
//
// Per item: q·k over the integer keys, a thread scoring one token against
// one of NS slices of the channels for GB heads at a time (queries read at
// one shared-memory address across the warp; K's 16-byte chunks staged
// XOR-swizzled by token, so a quarter warp's eight tokens read eight bank
// groups), the slices summed in order; s = (q·k)·2^-FL_k·scale (a power of
// two commutes exactly with fp32 rounding away from subnormals: the
// arithmetic of decoding first); m, l = Σ e^(s - m) per head; then
// acc = Σ_j (p_j·2^-FL_v)·v_int[j], a thread taking four channels of one of
// NQ token slices, the slices summed in order.  (m, l, acc) go to the
// workspace row of the item.  Positions at or past the length are never
// read.  GBT: the query heads a KV head serves when 1-4 (kept in registers
// at once), 0 for more (batches of four).
template <typename T, bool VEC, int GBT>
__global__ void __launch_bounds__(ATT_THREADS)
attn_split_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages, const int* __restrict__ fmt,
                  const int* __restrict__ ptab, const int* __restrict__ lens,
                  float* __restrict__ ws, int B, int H, int KV, int Dh, int ps, int P, int SP,
                  int S_max, float scale) {
    const int G = H / KV;
    constexpr int GB = GBT ? GBT : 4;             // heads a pass keeps in registers
    const int TS = SP * ps;                       // tokens a split covers
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr int W = Chunk<T, VEC>::W;
    constexpr int V4 = VEC ? 4 : 1;
    const int C = Dh / W;                         // chunks a row
    const int NQ = value_slices(Dh, VEC);
    const bool swz = VEC && C % 8 == 0;           // K staged XOR-swizzled
    const long long rs = static_cast<long long>(KV) * Dh;    // token stride in a page
    const long long n_items = static_cast<long long>(B) * KV * S_max;
    const long long step = gridDim.x;

    extern __shared__ __align__(16) unsigned char smem[];
    const SplitSmem L(G, Dh, TS, SP, NQ, sizeof(T));
    float* ss = reinterpret_cast<float*>(smem + L.s);        // (G, TS) scores, then p
    float* sp = reinterpret_cast<float*>(smem + L.sp);       // (NS, G, TS) slice dots

    // a register that carries the next item's page ids (thread c < SP holds
    // page c), loaded while the block computes
    int r_phys = 0;
    const bool q_vec = Dh % 4 == 0;               // q rows copied 16 bytes at a time

    auto buf = [&](int k) { return smem + k * L.buf; };
    auto load_ids = [&](const Item& it) {
        if (tid < it.npg)
            r_phys = ptab[static_cast<long long>(it.b) * P + static_cast<long long>(it.s) * SP + tid];
    };
    // the item's page ids, token offsets, FL rows, queries and K/V slices into
    // buffer k; everything past the page ids is copied asynchronously
    auto stage = [&](const Item& it, int k) {
        unsigned char* bb = buf(k);
        long long* soff = reinterpret_cast<long long*>(bb + L.off);
        float* sq = reinterpret_cast<float*>(bb + L.q);
        int* sfl = reinterpret_cast<int*>(bb + L.fl);
        int* sphys = reinterpret_cast<int*>(bb + L.phys);
        int* stpg = reinterpret_cast<int*>(bb + L.tpg);
        T* sk = reinterpret_cast<T*>(bb + L.k);
        T* sv = reinterpret_cast<T*>(bb + L.v);
        if (tid < it.npg) sphys[tid] = r_phys;
        __syncthreads();
        for (int j = tid; j < it.ntok; j += ATT_THREADS) {
            const int pg = j / ps;
            soff[j] = (static_cast<long long>(sphys[pg]) * ps + (j - pg * ps)) * rs +
                      static_cast<long long>(it.kvh) * Dh;
            stpg[j] = pg;
        }
        if (tid < it.npg) cp_async8(sfl + 2 * tid, fmt + 2 * static_cast<long long>(sphys[tid]));
        const float* qs = q + (static_cast<long long>(it.b) * H + static_cast<long long>(it.kvh) * G) * Dh;
        if (q_vec) {
            for (int e = tid; e < G * Dh / 4; e += ATT_THREADS) cp_async16(sq + 4 * e, qs + 4 * e);
        } else {
            for (int e = tid; e < G * Dh; e += ATT_THREADS) sq[e] = qs[e];
        }
        __syncthreads();
        // (token, chunk) pairs walked ATT_THREADS at a time without a division
        const int dj = ATT_THREADS / C, dc = ATT_THREADS - dj * C;
        int j = tid / C, c = tid - (tid / C) * C;
        while (j < it.ntok) {
            const long long off = soff[j] + c * W;
            if (VEC) {
                cp_async16(sk + j * Dh + (swz ? (c ^ (j & 7)) : c) * W, k_pages + off);
                cp_async16(sv + j * Dh + c * W, v_pages + off);
            } else {
                sk[j * Dh + c] = k_pages[off];
                sv[j * Dh + c] = v_pages[off];
            }
            c += dc;
            j += dj;
            if (c >= C) {
                c -= C;
                ++j;
            }
        }
    };

    long long i = blockIdx.x;
    Item cur;
    if (!next_item(i, n_items, step, lens, KV, S_max, P, ps, SP, cur)) return;
    load_ids(cur);
    stage(cur, 0);
    cp_async_commit();
    long long inx = i + step;
    Item nxt;
    bool has_nxt = next_item(inx, n_items, step, lens, KV, S_max, P, ps, SP, nxt);
    if (has_nxt) load_ids(nxt);
    int kb = 0;
    while (true) {
        // the next item's copies into the other buffer (its page ids arrived
        // while this block computed), then the page ids of the one after it
        if (has_nxt) stage(nxt, kb ^ 1);
        cp_async_commit();
        long long inn = inx + step;
        Item nn;
        const bool has_nn = has_nxt && next_item(inn, n_items, step, lens, KV, S_max, P, ps, SP, nn);
        if (has_nn) load_ids(nn);
        cp_async_wait_prev();                     // this item's copies landed
        __syncthreads();

        unsigned char* bb = buf(kb);
        const float* sq = reinterpret_cast<const float*>(bb + L.q);
        const int* sfl = reinterpret_cast<const int*>(bb + L.fl);
        const int* stpg = reinterpret_cast<const int*>(bb + L.tpg);
        const T* sk = reinterpret_cast<const T*>(bb + L.k);
        const T* sv = reinterpret_cast<const T*>(bb + L.v);
        float* sred = reinterpret_cast<float*>(bb + L.k);    // (NQ, G, Dh) after the scores
        const int ntok = cur.ntok;

        // q·k: thread (slice h, token lane jt)
        {
            const int CS = (C + NS - 1) / NS;     // chunks a slice
            const int h = tid / TP, jt = tid - (tid / TP) * TP;
            const int cb = h * CS, ce = min(C, cb + CS);
            for (int j = jt; j < ntok; j += TP) {
                for (int g0 = 0; g0 < G; g0 += GB) {
                    float acc[GB];
#pragma unroll
                    for (int u = 0; u < GB; ++u) acc[u] = 0.0f;
                    for (int c = cb; c < ce; ++c) {
                        float kf[W];
                        load_chunk<T, VEC>(sk + j * Dh + (swz ? (c ^ (j & 7)) : c) * W, kf);
#pragma unroll
                        for (int u = 0; u < GB; ++u) {
                            if (GBT || g0 + u < G) {
                                float qf[W];
#pragma unroll
                                for (int w = 0; w < W; w += (VEC ? 4 : 1))
                                    load_chunk<float, VEC>(sq + (g0 + u) * Dh + c * W + w,
                                                           qf + w);
#pragma unroll
                                for (int w = 0; w < W; ++w) acc[u] = fmaf(qf[w], kf[w], acc[u]);
                            }
                        }
                    }
#pragma unroll
                    for (int u = 0; u < GB; ++u)
                        if (GBT || g0 + u < G) sp[(h * G + g0 + u) * TS + j] = acc[u];
                }
            }
        }
        __syncthreads();

        // the split's softmax statistics, one warp a head
        constexpr int NWARPS = ATT_THREADS / 32;
        float* wrow = ws + ((static_cast<long long>(cur.b) * KV + cur.kvh) * S_max + cur.s) *
                               static_cast<long long>(G) * (Dh + 2);
        for (int g = warp; g < G; g += NWARPS) {
            float mx = NEG_INF;
            for (int j = lane; j < ntok; j += 32) {
                float dot = sp[g * TS + j];
                for (int hs = 1; hs < NS; ++hs) dot += sp[(hs * G + g) * TS + j];
                const float sc = dot * exp2i(-sfl[2 * stpg[j]]) * scale;
                ss[g * TS + j] = sc;
                mx = fmaxf(mx, sc);
            }
            mx = warp_max_all(mx);
            float sum = 0.0f;
            for (int j = lane; j < ntok; j += 32) {
                const float p = expf(ss[g * TS + j] - mx);
                ss[g * TS + j] = p * exp2i(-sfl[2 * stpg[j] + 1]);
                sum += p;
            }
            sum = warp_sum_all(sum);
            if (lane == 0) {
                wrow[G * Dh + g] = mx;
                wrow[G * Dh + G + g] = sum;
            }
        }
        __syncthreads();

        // acc = Σ_j (p_j·2^-FL_v)·v_int[j]: thread (token slice, V4 channels),
        // four tokens at a time
        {
            const int CV = Dh / V4;
            const int TQ = ((ntok + NQ - 1) / NQ + 3) & ~3;   // tokens a slice
            for (int g0 = 0; g0 < G; g0 += GB) {
                for (int e = tid; e < NQ * CV; e += ATT_THREADS) {
                    const int sl = e / CV, c = e - sl * CV;
                    float a[GB][V4];
#pragma unroll
                    for (int u = 0; u < GB; ++u)
#pragma unroll
                        for (int w = 0; w < V4; ++w) a[u][w] = 0.0f;
                    const int j_hi = min(ntok, (sl + 1) * TQ);
                    int j = sl * TQ;
                    if (TS % 4 == 0) {
                        for (; j + 4 <= j_hi; j += 4) {
                            float vf[4][V4];
#pragma unroll
                            for (int t = 0; t < 4; ++t)
                                load_v<T, VEC>(sv + (j + t) * Dh + c * V4, vf[t]);
#pragma unroll
                            for (int u = 0; u < GB; ++u) {
                                if (GBT || g0 + u < G) {
                                    const float4 p =
                                        *reinterpret_cast<const float4*>(ss + (g0 + u) * TS + j);
#pragma unroll
                                    for (int w = 0; w < V4; ++w) {
                                        a[u][w] = fmaf(p.x, vf[0][w], a[u][w]);
                                        a[u][w] = fmaf(p.y, vf[1][w], a[u][w]);
                                        a[u][w] = fmaf(p.z, vf[2][w], a[u][w]);
                                        a[u][w] = fmaf(p.w, vf[3][w], a[u][w]);
                                    }
                                }
                            }
                        }
                    }
                    for (; j < j_hi; ++j) {
                        float vf[V4];
                        load_v<T, VEC>(sv + j * Dh + c * V4, vf);
#pragma unroll
                        for (int u = 0; u < GB; ++u) {
                            if (GBT || g0 + u < G) {
                                const float p = ss[(g0 + u) * TS + j];
#pragma unroll
                                for (int w = 0; w < V4; ++w) a[u][w] = fmaf(p, vf[w], a[u][w]);
                            }
                        }
                    }
                    // sred aliases K, dead since the barrier after the scores
#pragma unroll
                    for (int u = 0; u < GB; ++u)
                        if (GBT || g0 + u < G)
#pragma unroll
                            for (int w = 0; w < V4; ++w)
                                sred[(sl * G + g0 + u) * Dh + c * V4 + w] = a[u][w];
                }
            }
        }
        __syncthreads();
        for (int e = tid; e < G * Dh; e += ATT_THREADS) {
            float a = 0.0f;
            for (int sl = 0; sl < NQ; ++sl) a += sred[sl * G * Dh + e];
            wrow[e] = a;
        }
        __syncthreads();                          // buffer kb is free again
        if (!has_nxt) break;
        cur = nxt;
        nxt = nn;
        inx = inn;
        has_nxt = has_nn;
        kb ^= 1;
    }
}

constexpr int MERGE_THREADS = 128;
constexpr int MERGE_OUT = 32;                   // outputs a merge block writes
constexpr int MERGE_PARTS = MERGE_THREADS / MERGE_OUT;

// Grid (chunk of MERGE_OUT of the G·Dh outputs, KV head, row): the row's
// used splits.  Each split's m and l into shared memory, m = max_s m_s,
// w_s = e^(m_s - m); then warp w sums l_s·w_s and acc_s·w_s over the w-th
// quarter of the splits, in split order, for the block's outputs (a lane an
// output), and the quarters add in order: out = acc / max(l, 1e-30).
__global__ void __launch_bounds__(MERGE_THREADS)
attn_merge_kernel(const float* __restrict__ ws, const int* __restrict__ lens,
                  float* __restrict__ out, int H, int KV, int Dh, int ps, int P, int SP,
                  int S_max) {
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int G = H / KV;
    const int len = min(max(lens[b], 0), P * ps);
    const int TS = SP * ps;
    const int ns = (len + TS - 1) / TS;           // used splits, <= S_max
    const long long R = static_cast<long long>(G) * (Dh + 2);
    const float* base = ws + (static_cast<long long>(b) * KV + kvh) * S_max * R;
    extern __shared__ float msm[];
    float* sw = msm;                              // (ns, G) m_s, then the weights
    float* sl = sw + static_cast<long long>(ns) * G;     // (ns, G) l_s
    float* sm = sl + static_cast<long long>(ns) * G;     // (G) m
    __shared__ float part_a[MERGE_PARTS][MERGE_OUT], part_l[MERGE_PARTS][MERGE_OUT];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int e = blockIdx.x * MERGE_OUT + lane;
    const int eg = min(e, G * Dh - 1);
    const int g = eg / Dh;
    const int qn = (ns + MERGE_PARTS - 1) / MERGE_PARTS;
    const int s_lo = warp * qn, s_hi = min(ns, s_lo + qn);
    // this warp's accumulators, loaded at once and with the m and l rows:
    // one trip to memory
    constexpr int MB = 16;
    float v[MB];
#pragma unroll
    for (int k = 0; k < MB; ++k) v[k] = s_lo + k < s_hi ? base[(s_lo + k) * R + eg] : 0.0f;
    for (int i = tid; i < ns * G; i += MERGE_THREADS) {
        const int si = i / G, gi = i - si * G;
        sw[i] = base[si * R + G * Dh + gi];
        sl[i] = base[si * R + G * Dh + G + gi];
    }
    __syncthreads();
    for (int gi = warp; gi < G; gi += MERGE_THREADS / 32) {
        float m = NEG_INF;
        for (int si = lane; si < ns; si += 32) m = fmaxf(m, sw[si * G + gi]);
        m = warp_max_all(m);                      // a max is exact in any order
        if (lane == 0) sm[gi] = m;
    }
    __syncthreads();
    for (int i = tid; i < ns * G; i += MERGE_THREADS) sw[i] = expf(sw[i] - sm[i % G]);
    __syncthreads();

    float l = 0.0f, a = 0.0f;
    for (int s0 = s_lo; s0 < s_hi; s0 += MB) {
        if (s0 > s_lo) {
#pragma unroll
            for (int k = 0; k < MB; ++k) v[k] = s0 + k < s_hi ? base[(s0 + k) * R + eg] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < MB; ++k) {
            if (s0 + k < s_hi) {
                const float w = sw[(s0 + k) * G + g];
                l += sl[(s0 + k) * G + g] * w;
                a += v[k] * w;
            }
        }
    }
    part_a[warp][lane] = a;
    part_l[warp][lane] = l;
    __syncthreads();
    if (warp == 0 && e < G * Dh) {
        float at = 0.0f, lt = 0.0f;
#pragma unroll
        for (int w = 0; w < MERGE_PARTS; ++w) {
            at += part_a[w][lane];
            lt += part_l[w][lane];
        }
        // a row of length 0 has l == 0 and acc == 0: exactly 0, not NaN
        out[(static_cast<long long>(b) * H + static_cast<long long>(kvh) * G) * Dh + e] =
            at / fmaxf(lt, 1e-30f);
    }
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (n <= 0) n = 1;
    }
    return n;
}

template <typename T, bool VEC, int GBT>
cudaError_t launch_split(const float* q, const void* kp, const void* vp, const int* fmt,
                         const int* ptab, const int* lens, float* ws, int B, int H, int KV,
                         int Dh, int ps, int P, int SP, int S_max, float scale,
                         cudaStream_t st) {
    const size_t smem = SplitSmem(H / KV, Dh, SP * ps, SP, value_slices(Dh, VEC), sizeof(T)).total;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            attn_split_kernel<T, VEC, GBT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    // as many blocks as fit on the card at once, each walking its items
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, attn_split_kernel<T, VEC, GBT>, ATT_THREADS, smem);
    if (e != cudaSuccess) return e;
    const long long items = static_cast<long long>(B) * KV * S_max;
    const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
    const unsigned grid = static_cast<unsigned>(items < fit ? items : fit);
    attn_split_kernel<T, VEC, GBT><<<grid, ATT_THREADS, smem, st>>>(
        q, static_cast<const T*>(kp), static_cast<const T*>(vp), fmt, ptab, lens, ws, B, H, KV,
        Dh, ps, P, SP, S_max, scale);
    return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_attn(const float* q, const void* kp, const void* vp, const int* fmt,
                        const int* ptab, const int* lens, float* ws, float* out, int B, int H,
                        int KV, int Dh, int ps, int P, int SP, int S_max, float scale,
                        cudaStream_t st) {
    const int G = H / KV;
    cudaError_t e;
    switch (G) {
#define K5_SPLIT(GBT) launch_split<T, VEC, GBT>(q, kp, vp, fmt, ptab, lens, ws, B, H, KV, Dh, \
                                                ps, P, SP, S_max, scale, st)
        case 1: e = K5_SPLIT(1); break;
        case 2: e = K5_SPLIT(2); break;
        case 3: e = K5_SPLIT(3); break;
        case 4: e = K5_SPLIT(4); break;
        default: e = K5_SPLIT(0);
#undef K5_SPLIT
    }
    if (e != cudaSuccess) return e;
    const size_t msmem = sizeof(float) * (2 * static_cast<size_t>(S_max) * G + G);
    if (msmem > 48 * 1024) {
        e = cudaFuncSetAttribute(attn_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(msmem));
        if (e != cudaSuccess) return e;
    }
    const dim3 mgrid(static_cast<unsigned>((G * Dh + MERGE_OUT - 1) / MERGE_OUT),
                     static_cast<unsigned>(KV), static_cast<unsigned>(B));
    attn_merge_kernel<<<mgrid, MERGE_THREADS, msmem, st>>>(ws, lens, out, H, KV, Dh, ps, P,
                                                           SP, S_max);
    return cudaGetLastError();
}

}  // namespace

// Plain C interface.  q (B, H, Dh) fp32; pools (n_pages, ps, KV, Dh) int8 or
// fp32; fmt (n_pages, 2) int32 [FL_k, FL_v]; ptab (B, P) int32; lens (B)
// int32; out (B, H, Dh) fp32; ws fp32 scratch of B·KV·S_max·G·(Dh + 2)
// floats, S_max = ceil(P / split_pages).  All contiguous device memory, the
// pools and q 16-byte aligned, fmt 8-byte aligned.  Two launches on `stream` (split, merge), no
// synchronisation; returns the first launch error.
extern "C" int paged_decode_attn(const void* q, const void* k_pages, const void* v_pages,
                                 int pool_is_int8, const void* fmt, const void* ptab,
                                 const void* lens, void* out, void* ws, int B, int H, int KV,
                                 int Dh, int ps, int P, int split_pages, float scale,
                                 void* stream) {
    if (B <= 0) return 0;
    // a thread of the split block carries each page id of a split
    if (KV < 1 || H % KV || Dh < 1 || ps < 1 || P < 1 || split_pages < 1 ||
        split_pages > ATT_THREADS)
        return static_cast<int>(cudaErrorInvalidValue);
    const int S_max = (P + split_pages - 1) / split_pages;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* qf = static_cast<const float*>(q);
    const int* f = static_cast<const int*>(fmt);
    const int* pt = static_cast<const int*>(ptab);
    const int* ln = static_cast<const int*>(lens);
    float* w = static_cast<float*>(ws);
    float* o = static_cast<float*>(out);
    cudaError_t e;
    if (pool_is_int8)
        e = Dh % 16 == 0
            ? launch_attn<signed char, true>(qf, k_pages, v_pages, f, pt, ln, w, o, B, H, KV,
                                             Dh, ps, P, split_pages, S_max, scale, s)
            : launch_attn<signed char, false>(qf, k_pages, v_pages, f, pt, ln, w, o, B, H, KV,
                                              Dh, ps, P, split_pages, S_max, scale, s);
    else
        e = Dh % 4 == 0
            ? launch_attn<float, true>(qf, k_pages, v_pages, f, pt, ln, w, o, B, H, KV, Dh,
                                       ps, P, split_pages, S_max, scale, s)
            : launch_attn<float, false>(qf, k_pages, v_pages, f, pt, ln, w, o, B, H, KV, Dh,
                                        ps, P, split_pages, S_max, scale, s);
    return static_cast<int>(e);
}
