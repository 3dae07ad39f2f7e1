// Shared constants and the cell decode of the rank-plane layout
// (gpufluidsimulator_torch/ops/planes.py): a cell index is
// ((z * n_bx + xo) * py + y) * 128 + lane, and rank k of field f lives at
// (f * K + k) * cells + cell.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

#define FK_SENTINEL 1.0e6f
#define FK_HALF_SENTINEL 5.0e5f   // SENTINEL * 0.5: valid iff x < this
#define FK_LANES 128
#define FK_TILE_X 126
#define FK_ROWS_PER_BLOCK 8
#define FK_MAX_DEVICES 64

// Past 48 KB, a block gets only the dynamic shared memory its kernel opted
// in to.  One FkOptIn per kernel (a function-local static) sets it once
// per device.
struct FkOptIn {
    std::atomic<bool> done[FK_MAX_DEVICES];

    template <typename Kernel>
    cudaError_t operator()(Kernel kernel, int bytes) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        if (dev < FK_MAX_DEVICES && done[dev].load(std::memory_order_relaxed))
            return cudaSuccess;
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err == cudaSuccess && dev < FK_MAX_DEVICES)
            done[dev].store(true, std::memory_order_relaxed);
        return err;
    }
};

// Layout of one launch: the plane geometry plus the derived z stride.
struct FkGeom {
    int dim, k, nx, ny, nz, n_bx, py, pz;
    long long cells;
};

// (lane, y, x tile, z) of a cell index
struct FkCell {
    int lane, y, xo, z;
};

__device__ __forceinline__ FkCell fk_decode(long long c, const FkGeom& g) {
    FkCell r;
    r.lane = (int)(c & (FK_LANES - 1));
    const long long row = c >> 7;
    r.y = (int)(row % g.py);
    const long long zx = row / g.py;
    r.xo = (int)(zx % g.n_bx);
    r.z = (int)(zx / g.n_bx);
    return r;
}

// True for the cells a particle can bin into (planes.interior_mask): lanes
// 1..126 of the x tile with global x < nx, rows 8..8+ny-1, planes 1..nz
// (3D) or plane 0 (2D).  Every 3^d neighbour of such a cell is inside the
// array.
__device__ __forceinline__ bool fk_interior(long long c, const FkGeom& g) {
    const FkCell d = fk_decode(c, g);
    if (d.lane < 1 || d.lane > FK_TILE_X) return false;
    if (d.xo * FK_TILE_X + d.lane - 1 >= g.nx) return false;
    if (d.y < FK_ROWS_PER_BLOCK || d.y >= FK_ROWS_PER_BLOCK + g.ny)
        return false;
    if (g.dim == 3) return d.z >= 1 && d.z <= g.nz;
    return d.z == 0;
}

// Sum of per-thread ints over the block (blockDim.x a multiple of 32, at
// most 1024); the result is valid in thread 0.
__device__ __forceinline__ int fk_block_sum(int v) {
    __shared__ int warp_sums[32];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) warp_sums[w] = v;
    __syncthreads();
    int total = 0;
    if (threadIdx.x == 0)
        for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += warp_sums[i];
    return total;
}
