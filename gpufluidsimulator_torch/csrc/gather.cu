// Kernel 5: per-particle values out of the rank planes.
//
// Replaces gpufluidsimulator_tpu/ops/route.py:_extract_kernel and
// route.py:_stitch_kernel together.  On the TPU those two invert the
// placement butterfly and stitch per-tile runs back into particle order,
// because the TPU has no per-lane gather; their combined contract (the
// reference's own CPU path, route.py:630-635) is
//   out[i, c] = stack[c].flat[min(slot[i], K * cells - 1)]
// and on Hopper that is one gather.
//
// Bound on the H100: bytes — N slot indices, N * C values read at the
// slots, N * C values written (9.4 MB at the 260,850-particle 3D dam break
// with C = 4, 0.0028 ms at 3.35 TB/s).
//
// The first design (one thread per output element (i, c)) paid a 64-bit
// division per element, read each slot C times and spread a warp's loads
// over C planes.  This design: one thread per particle.  Its slot is read
// once and clamped in 32-bit arithmetic (64-bit only for the plane
// offsets), its C loads are issued together, and its row goes out as one
// float4 store (C = 4) or C neighbouring scalar stores (C = 3, or any C
// through the generic instantiation).  The particles are slot-sorted, so a
// warp's loads of one plane mostly fall on neighbouring addresses.
#include "common.cuh"

#define FK_GATHER_THREADS 256

// C > 0: the channel count at compile time; C == 0: c at run time
template <int C>
__global__ void __launch_bounds__(FK_GATHER_THREADS)
gather_kernel(const float* __restrict__ stack, const int* __restrict__ slot,
              float* __restrict__ out, int n, int c, long long m,
              int last) {
    const int i = blockIdx.x * FK_GATHER_THREADS + threadIdx.x;
    if (i >= n) return;
    const int s = min(max(slot[i], 0), last);
    if constexpr (C > 0) {
        float v[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) v[ch] = stack[ch * m + s];
        if constexpr (C == 4) {
            reinterpret_cast<float4*>(out)[i] =
                make_float4(v[0], v[1], v[2], v[3]);
        } else {
            float* row = out + (long long)i * C;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) row[ch] = v[ch];
        }
    } else {
        float* row = out + (long long)i * c;
        for (int ch = 0; ch < c; ++ch) row[ch] = stack[ch * m + s];
    }
}

// stack: (c, m) float32; slot: (n,) int32; out: (n, c) float32, 16-byte
// aligned (a fresh allocation)
extern "C" int fk_gather(const float* stack, const int* slot, float* out,
                         int n, int c, long long m, void* stream) {
    if (n < 0 || c < 1 || m < 1) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    // slots are int32, so the last slot they can name fits one too
    const int last = (int)(m - 1 < 0x7fffffffLL ? m - 1 : 0x7fffffffLL);
    const unsigned blocks = (unsigned)((n + FK_GATHER_THREADS - 1)
                                       / FK_GATHER_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (c == 4)
        gather_kernel<4><<<blocks, FK_GATHER_THREADS, 0, st>>>(
            stack, slot, out, n, c, m, last);
    else if (c == 3)
        gather_kernel<3><<<blocks, FK_GATHER_THREADS, 0, st>>>(
            stack, slot, out, n, c, m, last);
    else
        gather_kernel<0><<<blocks, FK_GATHER_THREADS, 0, st>>>(
            stack, slot, out, n, c, m, last);
    return (int)cudaGetLastError();
}

// the text of a CUDA error code, for the wrappers' exceptions
extern "C" const char* fk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
