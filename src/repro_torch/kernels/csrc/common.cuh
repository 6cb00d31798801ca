// Helpers shared by the kernels of this library.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Bit-exact 2^n for n in [-126, 127], assembled from the exponent bits.
// exp2f is not bound to be exact, and one inexact scale knocks every value
// off the <IL, FL> grid.
__device__ __forceinline__ float exp2i(int n) {
    n = min(max(n, -126), 127);
    return __int_as_float((n + 127) << 23);
}

// Philox4x32-10 (Salmon et al., SC'11), written out by hand: a counter-based
// generator, so element e's bits are a pure function of (seed, e) whatever
// the launch geometry.  Key = the 64-bit seed (low word first); counter =
// e / 4 as a 128-bit number; word e % 4 of the output belongs to element e.
// The plain twin is `philox_bits` in kernels/dps_quant.py.
struct Philox4 {
    uint32_t v[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint64_t ctr, uint64_t seed) {
    uint32_t c0 = static_cast<uint32_t>(ctr), c1 = static_cast<uint32_t>(ctr >> 32);
    uint32_t c2 = 0u, c3 = 0u;
    uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
        const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
        const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
        c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    }
    Philox4 out;
    out.v[0] = c0; out.v[1] = c1; out.v[2] = c2; out.v[3] = c3;
    return out;
}

// SplitMix64 and the seed fold of repro_torch.core.fixed_point.fold_seed for
// one integer: fold_seed(seed, d) = splitmix64(seed ^ splitmix64(d)).  A
// kernel keys a stream per group with it, so the host hands it one seed.
__device__ __forceinline__ uint64_t splitmix64(uint64_t z) {
    z += 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

__device__ __forceinline__ uint64_t fold_seed(uint64_t seed, uint64_t d) {
    return splitmix64(seed ^ splitmix64(d));
}

// Reductions in a fixed order, so a result does not change from run to run.
__device__ __forceinline__ float warp_sum_down(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;       // lane 0 holds the sum
}

__device__ __forceinline__ float warp_max_down(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;       // lane 0 holds the max
}

__device__ __forceinline__ float warp_sum_all(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;       // every lane holds the sum
}

__device__ __forceinline__ float warp_max_all(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;       // every lane holds the max
}
