// Shared constants and the cell decode of the rank-plane layout
// (gpufluidsimulator_torch/ops/planes.py): a cell index is
// ((z * n_bx + xo) * py + y) * 128 + lane, and rank k of field f lives at
// (f * K + k) * cells + cell.
#pragma once

#include <cuda_runtime.h>

#define FK_SENTINEL 1.0e6f
#define FK_HALF_SENTINEL 5.0e5f   // SENTINEL * 0.5: valid iff x < this
#define FK_LANES 128
#define FK_TILE_X 126
#define FK_ROWS_PER_BLOCK 8

// Layout of one launch: the plane geometry plus the derived z stride.
struct FkGeom {
    int dim, k, nx, ny, nz, n_bx, py, pz;
    long long cells;
};

// True for the cells a particle can bin into (planes.interior_mask): lanes
// 1..126 of the x tile with global x < nx, rows 8..8+ny-1, planes 1..nz
// (3D) or plane 0 (2D).  Every 3^d neighbour of such a cell is inside the
// array.
__device__ __forceinline__ bool fk_interior(long long c, const FkGeom& g) {
    const int lane = (int)(c & (FK_LANES - 1));
    const long long row = c >> 7;
    const int y = (int)(row % g.py);
    const long long zx = row / g.py;
    const int xo = (int)(zx % g.n_bx);
    const int z = (int)(zx / g.n_bx);
    if (lane < 1 || lane > FK_TILE_X) return false;
    if (xo * FK_TILE_X + lane - 1 >= g.nx) return false;
    if (y < FK_ROWS_PER_BLOCK || y >= FK_ROWS_PER_BLOCK + g.ny) return false;
    if (g.dim == 3) return z >= 1 && z <= g.nz;
    return z == 0;
}
