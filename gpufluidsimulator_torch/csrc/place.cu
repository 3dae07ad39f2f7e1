// Kernel 2: placement of slot-sorted particles into rank planes.
//
// Replaces gpufluidsimulator_tpu/ops/route.py:_placement_kernel, as a
// contract rather than a mechanism: the TPU kernel butterfly-routes each
// 8,192-slot tile because it has no per-lane scatter; Hopper has one.
//   pass 1 (fill):    out[f, j] = f < n_pos ? SENTINEL : 0   for every slot
//   pass 2 (scatter): out[f, slot[i]] = fields[f, i]          for ok[i]
// Kept slots are unique (rank-major slot = rank * cells + cell), so the
// scatter has no conflicts and needs no atomics.  No routing `shifts`
// channel is written: nothing in the port reads it.
//
// Bound on the H100: bytes.  The fill writes F * K * cells * 4 B (233 MB for
// the 6 channels of the 260,850-particle 3D dam break); the scatter reads
// F * N * 4 B and writes as much.  Design: the fill streams float4 stores
// through a grid-stride loop; the scatter is one thread per particle, whose
// loads of each field are coalesced and whose stores land in increasing
// slot order (the particles are slot-sorted).
#include "common.cuh"

__global__ void place_fill_kernel(float4* __restrict__ out, long long m4,
                                  int n_fields, int n_pos) {
    const long long total = m4 * n_fields;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         j < total; j += stride) {
        const int f = (int)(j / m4);
        const float v = f < n_pos ? FK_SENTINEL : 0.0f;
        out[j] = make_float4(v, v, v, v);
    }
}

__global__ void place_scatter_kernel(const float* __restrict__ fields,
                                     const int* __restrict__ slot,
                                     const bool* __restrict__ ok,
                                     float* __restrict__ out, int n,
                                     int n_fields, long long m) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !ok[i]) return;
    const long long s = slot[i];
    if (s < 0 || s >= m) return;
    for (int f = 0; f < n_fields; ++f)
        out[(long long)f * m + s] = fields[(long long)f * n + i];
}

extern "C" int fk_place(const float* fields, const int* slot, const bool* ok,
                        float* out, int n, int n_fields, int n_pos,
                        long long m, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    // m = K * cells is a multiple of 128, so each channel is whole float4s
    const long long m4 = m / 4;
    long long blocks = (m4 * n_fields + 255) / 256;
    if (blocks > 132LL * 32) blocks = 132LL * 32;
    if (blocks > 0)
        place_fill_kernel<<<(unsigned)blocks, 256, 0, st>>>(
            reinterpret_cast<float4*>(out), m4, n_fields, n_pos);
    if (n > 0)
        place_scatter_kernel<<<(n + 255) / 256, 256, 0, st>>>(
            fields, slot, ok, out, n, n_fields, m);
    return (int)cudaGetLastError();
}
