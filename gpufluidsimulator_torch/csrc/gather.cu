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
// Bound on the H100: bytes — N * C values read at scattered slots, N slot
// indices, N * C values written.  Design: one thread per output element
// (i, c), so the stores are fully coalesced; the loads follow the slot
// order of the particles, which is increasing (slot-sorted), so
// neighbouring threads mostly read neighbouring addresses.
#include "common.cuh"

__global__ void gather_kernel(const float* __restrict__ stack,
                              const int* __restrict__ slot,
                              float* __restrict__ out, int n, int c,
                              long long m) {
    const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (e >= (long long)n * c) return;
    const int i = (int)(e / c);
    const int ch = (int)(e - (long long)i * c);
    long long s = slot[i];
    if (s > m - 1) s = m - 1;
    if (s < 0) s = 0;
    out[e] = stack[(long long)ch * m + s];
}

extern "C" int fk_gather(const float* stack, const int* slot, float* out,
                         int n, int c, long long m, void* stream) {
    const long long total = (long long)n * c;
    if (total > 0)
        gather_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(stack, slot, out, n, c, m);
    return (int)cudaGetLastError();
}

// the text of a CUDA error code, for the wrappers' exceptions
extern "C" const char* fk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
