// Kernel 1: per-row maximum cell occupancy.
//
// Replaces gpufluidsimulator_tpu/ops/planes.py:_occ_rowmax_kernel.  For each
// (z, x-tile, y) row of 128 lanes: count the ranks k < K with
// x[k, row, lane] < SENTINEL/2, then take the max over the lanes.
//
// Bound on the H100: bytes.  It reads the K x-planes once (K * cells * 4 B,
// 38.8 MB at the 260,850-particle 3D dam break) and does one compare per
// element.  Design: one 128-thread block per row; thread = lane, so each
// rank's read is one coalesced 512-byte row; the lane max is two warp
// shuffle trees and a 4-entry shared-memory max.
#include "common.cuh"

__global__ void occ_rowmax_kernel(const float* __restrict__ x,
                                  int* __restrict__ out, int k,
                                  long long cells) {
    const long long row = blockIdx.x;
    const int lane = threadIdx.x;
    const float* p = x + row * FK_LANES + lane;
    int cnt = 0;
    for (int kk = 0; kk < k; ++kk)
        cnt += (p[(long long)kk * cells] < FK_HALF_SENTINEL) ? 1 : 0;
    for (int o = 16; o > 0; o >>= 1)
        cnt = max(cnt, __shfl_xor_sync(0xffffffffu, cnt, o));
    __shared__ int wmax[FK_LANES / 32];
    if ((lane & 31) == 0) wmax[lane >> 5] = cnt;
    __syncthreads();
    if (lane == 0)
        out[row] = max(max(wmax[0], wmax[1]), max(wmax[2], wmax[3]));
}

extern "C" int fk_occ_rowmax(const float* x, int* out, int k, long long rows,
                             long long cells, void* stream) {
    if (rows > 0)
        occ_rowmax_kernel<<<(unsigned)rows, FK_LANES, 0,
                            (cudaStream_t)stream>>>(x, out, k, cells);
    return (int)cudaGetLastError();
}
