// Paged decode attention over an int8 (or fp32) KV page pool, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_paged_attn_kernel` of
// src/repro/kernels/paged_attn.py (entry `paged_attn_pallas`): one query
// token per batch row attends over that row's pages.  A page is found through
// the page table, its int8 grid integers are multiplied by 2^-FL of that
// page in registers, the scores of the query heads that share a KV head are
// scaled and masked at the row's length, and the page is folded into an
// online softmax (m, l, acc).  The fp32 cache never exists in device memory.
//
// Bound on this card: bytes.  A row of length n reads n·KV·Dh bytes of K and
// of V and does 4·n·H·Dh fp32 operations: about G = H/KV operations a byte,
// far below what the card can do per byte it reads.  So each K/V byte is read
// from device memory once: one block per (batch row, KV head) stages the
// page's slice for its head in shared memory, already decoded, and all G
// query heads of the group score against it.  The TPU's sequential page grid
// dimension becomes a loop inside the block over chunks of a few pages (about
// 64 tokens): all loads of a chunk are in flight together, so the trip to
// device memory and the block barriers are paid per chunk, not per page.  The
// loop ends at the row's last page, since later pages contribute exactly
// nothing.  Within a chunk a thread keeps several loads, and a warp several
// dot products, in flight at once.  What it costs is latency, not bytes: with B*KV blocks of one row
// each, the longest row sets the time.  Plain fp32 FMA throughout: no tensor
// cores, no TF32.

#include "common.cuh"

namespace {

constexpr int ATT_THREADS = 256;
constexpr int CHUNK_TOKENS = 64;     // tokens staged per loop iteration
constexpr int STAGE_ILP = 4;         // load pairs a thread keeps in flight
constexpr int SCORE_ILP = 4;         // positions a warp scores at once
// finite, as in the reference: exp(NEG_INF - m) underflows to exactly 0
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load4f(const signed char* p, float* o) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    o[0] = static_cast<float>(c.x); o[1] = static_cast<float>(c.y);
    o[2] = static_cast<float>(c.z); o[3] = static_cast<float>(c.w);
}

__device__ __forceinline__ void load4f(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

// Stage the (TC, Dh) slices of K and V of one chunk of C pages for one KV
// head into shared memory as decoded fp32 (TC = C * ps tokens).  The chunk's
// physical page ids and 2^-FL units were put into sphys/sunit beforehand, so
// every load here is independent of every other: a thread issues STAGE_ILP
// pairs of loads before it touches the first result, and the whole chunk
// costs about one trip to device memory.  Page slots at or past `npages`
// stage zeros.
template <typename T>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ k_pages,
                                            const T* __restrict__ v_pages,
                                            const int* sphys, const float* sunit,
                                            float* sk, float* sv, int p0, int npages,
                                            int C, int ps, int KV, int kvh, int Dh,
                                            bool vec) {
    const int step = vec ? 4 : 1;
    const int n = C * ps * Dh / step;
    const long long row_stride = static_cast<long long>(KV) * Dh;
    for (int i0 = threadIdx.x; i0 < n; i0 += STAGE_ILP * ATT_THREADS) {
        float kf[STAGE_ILP][4], vf[STAGE_ILP][4];
#pragma unroll
        for (int u = 0; u < STAGE_ILP; ++u) {
#pragma unroll
            for (int w = 0; w < 4; ++w) kf[u][w] = vf[u][w] = 0.0f;
            const int e = step * (i0 + u * ATT_THREADS);
            const int jj = e / Dh, d = e % Dh;       // token in chunk, channel
            const int c = jj / ps, j = jj % ps;      // page in chunk, token in page
            if (i0 + u * ATT_THREADS < n && p0 + c < npages) {
                const long long off =
                    (static_cast<long long>(sphys[c]) * ps + j) * row_stride +
                    static_cast<long long>(kvh) * Dh + d;
                if (vec) {
                    load4f(k_pages + off, kf[u]);
                    load4f(v_pages + off, vf[u]);
                } else {
                    kf[u][0] = static_cast<float>(k_pages[off]);
                    vf[u][0] = static_cast<float>(v_pages[off]);
                }
            }
        }
#pragma unroll
        for (int u = 0; u < STAGE_ILP; ++u) {
            const int i = i0 + u * ATT_THREADS;
            if (i >= n) continue;
            const int e = step * i;
            const int c = (e / Dh) / ps;
            const float ku = sunit[2 * c], vu = sunit[2 * c + 1];
            if (vec) {
                *reinterpret_cast<float4*>(sk + e) =
                    make_float4(kf[u][0] * ku, kf[u][1] * ku, kf[u][2] * ku, kf[u][3] * ku);
                *reinterpret_cast<float4*>(sv + e) =
                    make_float4(vf[u][0] * vu, vf[u][1] * vu, vf[u][2] * vu, vf[u][3] * vu);
            } else {
                sk[e] = kf[u][0] * ku;
                sv[e] = vf[u][0] * vu;
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
paged_decode_attn_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                         const T* __restrict__ v_pages, const int* __restrict__ fmt,
                         const int* __restrict__ ptab, const int* __restrict__ lens,
                         float* __restrict__ out, int H, int KV, int Dh, int ps, int P,
                         int C, float scale) {
    const int b = blockIdx.x, kvh = blockIdx.y;
    const int G = H / KV;                // query heads kvh*G .. kvh*G + G - 1
    const int TC = C * ps;               // tokens per chunk
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr int NWARPS = ATT_THREADS / 32;

    extern __shared__ float smem[];
    float* sq = smem;                    // (G, Dh) queries
    float* sacc = sq + G * Dh;           // (G, Dh) running value
    float* sk = sacc + G * Dh;           // (TC, Dh) decoded K chunk
    float* sv = sk + TC * Dh;            // (TC, Dh) decoded V chunk
    float* ss = sv + TC * Dh;            // (G, TC) scores, then probabilities
    float* sm = ss + G * TC;             // (G) running max
    float* sl = sm + G;                  // (G) running normalizer
    float* scorr = sl + G;               // (G) this chunk's correction
    float* sunit = scorr + G;            // (C, 2) this chunk's 2^-FL_k, 2^-FL_v
    int* sphys = reinterpret_cast<int*>(sunit + 2 * C);   // (C) physical pages

    const long long qbase = (static_cast<long long>(b) * H + kvh * G) * Dh;
    for (int e = tid; e < G * Dh; e += ATT_THREADS) {
        sq[e] = q[qbase + e];
        sacc[e] = 0.0f;
    }
    for (int g = tid; g < G; g += ATT_THREADS) {
        sm[g] = NEG_INF;
        sl[g] = 0.0f;
    }
    __syncthreads();

    const int len = min(max(lens[b], 0), P * ps);
    const int npages = (len + ps - 1) / ps;      // later pages add exactly 0
    const bool vec = (Dh % 4) == 0;
    const int* ptab_row = ptab + static_cast<long long>(b) * P;

    for (int p0 = 0; p0 < npages; p0 += C) {
        for (int c = tid; c < C; c += ATT_THREADS) {
            const bool live = p0 + c < npages;
            const int phys = live ? ptab_row[p0 + c] : 0;
            sphys[c] = phys;
            sunit[2 * c] = live ? exp2i(-fmt[2 * phys]) : 0.0f;
            sunit[2 * c + 1] = live ? exp2i(-fmt[2 * phys + 1]) : 0.0f;
        }
        __syncthreads();
        stage_chunk(k_pages, v_pages, sphys, sunit, sk, sv, p0, npages, C, ps, KV,
                    kvh, Dh, vec);
        __syncthreads();
        const int pos0 = p0 * ps;        // absolute position of the chunk's start

        // scores: a warp takes SCORE_ILP positions of one query head at a
        // time, so their dot products and lane reductions overlap
        const int nblk = (TC + SCORE_ILP - 1) / SCORE_ILP;
        for (int idx = warp; idx < G * nblk; idx += NWARPS) {
            const int g = idx / nblk, j0 = (idx % nblk) * SCORE_ILP;
            float s[SCORE_ILP];
#pragma unroll
            for (int u = 0; u < SCORE_ILP; ++u) s[u] = 0.0f;
            for (int d = lane; d < Dh; d += 32) {
                const float qv = sq[g * Dh + d];
#pragma unroll
                for (int u = 0; u < SCORE_ILP; ++u)
                    if (j0 + u < TC) s[u] += qv * sk[(j0 + u) * Dh + d];
            }
#pragma unroll
            for (int u = 0; u < SCORE_ILP; ++u) s[u] = warp_sum_all(s[u]);
            if (lane == 0) {
#pragma unroll
                for (int u = 0; u < SCORE_ILP; ++u)
                    if (j0 + u < TC)
                        ss[g * TC + j0 + u] =
                            s[u] * scale + ((pos0 + j0 + u < len) ? 0.0f : NEG_INF);
            }
        }
        __syncthreads();

        // online softmax: one warp per query head
        for (int g = warp; g < G; g += NWARPS) {
            const float m_old = sm[g], l_old = sl[g];
            float bm = -INFINITY;
            for (int j = lane; j < TC; j += 32) bm = fmaxf(bm, ss[g * TC + j]);
            bm = warp_max_all(bm);
            const float m_new = fmaxf(m_old, bm);
            float psum = 0.0f;
            for (int j = lane; j < TC; j += 32) {
                // the multiply by `valid` matters: where everything is masked
                // s - m_new is 0 and exp gives 1 per position
                const float valid = (pos0 + j < len) ? 1.0f : 0.0f;
                const float pr = expf(ss[g * TC + j] - m_new) * valid;
                ss[g * TC + j] = pr;
                psum += pr;
            }
            psum = warp_sum_all(psum);
            if (lane == 0) {
                const float corr = expf(m_old - m_new);
                scorr[g] = corr;
                sm[g] = m_new;
                sl[g] = l_old * corr + psum;
            }
        }
        __syncthreads();

        // value: acc = acc * corr + p @ V, one thread per (head, channel)
        for (int e = tid; e < G * Dh; e += ATT_THREADS) {
            const int g = e / Dh, d = e % Dh;
            float a = sacc[e] * scorr[g];
            for (int j = 0; j < TC; ++j) a += ss[g * TC + j] * sv[j * Dh + d];
            sacc[e] = a;
        }
        __syncthreads();
    }

    // a row of length 0 has l == 0 and acc == 0: exactly 0, not NaN
    for (int e = tid; e < G * Dh; e += ATT_THREADS)
        out[qbase + e] = sacc[e] / fmaxf(sl[e / Dh], 1e-30f);
}

template <typename T>
cudaError_t launch_attn(const float* q, const void* kp, const void* vp, const int* fmt,
                        const int* ptab, const int* lens, float* out, int B, int H,
                        int KV, int Dh, int ps, int P, float scale, cudaStream_t s) {
    const int G = H / KV;
    // pages per chunk: about CHUNK_TOKENS tokens, at least one page
    int C = CHUNK_TOKENS / ps;
    C = C > P ? P : C;
    C = C < 1 ? 1 : C;
    const size_t TC = static_cast<size_t>(C) * ps;
    const size_t smem = sizeof(float) *
        (2 * static_cast<size_t>(G) * Dh + 2 * TC * Dh + G * TC + 3 * static_cast<size_t>(G) +
         3 * static_cast<size_t>(C));
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            paged_decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(KV));
    paged_decode_attn_kernel<T><<<grid, ATT_THREADS, smem, s>>>(
        q, static_cast<const T*>(kp), static_cast<const T*>(vp), fmt, ptab, lens, out,
        H, KV, Dh, ps, P, C, scale);
    return cudaGetLastError();
}

}  // namespace

// Plain C interface.  q (B, H, Dh) fp32; pools (n_pages, ps, KV, Dh) int8 or
// fp32; fmt (n_pages, 2) int32 [FL_k, FL_v]; ptab (B, P) int32; lens (B)
// int32; out (B, H, Dh) fp32.  All contiguous device memory.  Launches on
// `stream`, does not synchronise, returns the launch's error code.
extern "C" int paged_decode_attn(const void* q, const void* k_pages, const void* v_pages,
                                 int pool_is_int8, const void* fmt, const void* ptab,
                                 const void* lens, void* out, int B, int H, int KV,
                                 int Dh, int ps, int P, float scale, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* qf = static_cast<const float*>(q);
    const int* f = static_cast<const int*>(fmt);
    const int* pt = static_cast<const int*>(ptab);
    const int* ln = static_cast<const int*>(lens);
    float* o = static_cast<float*>(out);
    const cudaError_t e = pool_is_int8
        ? launch_attn<signed char>(qf, k_pages, v_pages, f, pt, ln, o, B, H, KV, Dh, ps, P, scale, s)
        : launch_attn<float>(qf, k_pages, v_pages, f, pt, ln, o, B, H, KV, Dh, ps, P, scale, s);
    return static_cast<int>(e);
}
