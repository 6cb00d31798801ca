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
