// The z-marching column of the rank-plane sweeps (csrc/force.cu, all three
// modes; csrc/density.cu): a ring of compacted staged planes.
//
// A block of FK_THREADS threads owns the tile of FK_TILE_ROWS rows x 32
// lanes of csrc/tile.cuh in each of ZN consecutive z planes of one x tile
// (ZN a kernel's own constant), and walks them upwards.  At each plane it
// finds the tile's queries (the force kernels lay them out and fill the
// empty slots with fk_tile_queries and fk_tile_fill; the density sweep
// takes them from the staged plane z); a plane with queries then needs its
// neighbour planes z-1, z, z+1 staged, each as the 6 rows x 34 lanes
// around the tile.  The ring holds FR_RING staged planes (plane p in ring
// slot p % 3), so a march through planes that hold queries stages one new
// plane a step and drops the oldest: each staged slot serves every query
// of the column that reads it, over all of its query rounds.
//
// A ring plane is compacted: only the valid ranks of each cell, cell by
// cell in row-major order, ranks in order.  Its staging (fr_count) first
// counts each cell's valid ranks, one thread a cell with every rank's x
// in flight (bounded by the plane's occ_s, stopping at the first sentinel
// rank), and scans the counts into offsets (off[cell], off[cells] the
// plane's total); then one thread per valid slot finds its cell by binary
// search in the offsets and stages it (fr_stage).  The three cells of a
// query's row are neighbours in the layout, so a force query walks one
// range of slots a row (fr_pairs), in the order dx, rank (the density
// sweep walks them rank by rank, its own order).  A ring plane holds at
// most a kernel's own capacity of slots: a plane with more is staged, and
// walked, in windows of that many slots, one window at a time between two
// barriers, each time it is read (the same pair order, only slower), or
// read from memory (density); a block counts each such plane once in its
// kernel's overflow counter.
#pragma once

#include "tile.cuh"

#define FR_RING 3               // staged planes a block holds: z-1, z, z+1
#define FR_SCAN_WARPS ((FK_STAGE_CELLS + 31) / 32)
static_assert(FR_SCAN_WARPS <= FK_THREADS / 32,
              "a thread counts each staged cell");

// The ring's offsets (off[slot][cell], off[slot][FK_STAGE_CELLS] the
// plane's total) and the counting scan's per-warp sums
struct FrRing {
    int off[FR_RING][FK_STAGE_CELLS + 1];
    int wsum[FR_SCAN_WARPS];
};

// A block's column: the lanes and rows of its tile in each plane, its x
// tile and its planes z0 .. z1 - 1
struct FrColumn {
    int lane0, y0, xo, z0, z1;
};

// Blocks of a launch whose columns march ZN planes each
template <int ZN>
__host__ __device__ inline long long fr_blocks(const FkGeom& g) {
    return (long long)((g.pz + ZN - 1) / ZN) * g.n_bx
        * (g.py / FK_TILE_ROWS) * FK_TILES_PER_ROW;
}

template <int ZN>
__device__ __forceinline__ FrColumn fr_column(const FkGeom& g) {
    FrColumn c;
    long long b = blockIdx.x;
    c.lane0 = (int)(b % FK_TILES_PER_ROW) * FK_TILE_LANES;
    b /= FK_TILES_PER_ROW;
    const int tiles_y = g.py / FK_TILE_ROWS;
    c.y0 = (int)(b % tiles_y) * FK_TILE_ROWS;
    b /= tiles_y;
    c.xo = (int)(b % g.n_bx);
    c.z0 = (int)(b / g.n_bx) * ZN;
    c.z1 = min(c.z0 + ZN, g.pz);
    return c;
}

// The column's tile in plane z
template <int DIM>
__device__ __forceinline__ FkTile fr_tile(const FkGeom& g, const FkOcc& occ,
                                          const FrColumn& c, int z) {
    FkTile t;
    t.row0 = ((long long)z * g.n_bx + c.xo) * g.py + c.y0;
    t.lane0 = c.lane0;
    t.base = t.row0 * FK_LANES + t.lane0;
    t.y0 = c.y0;
    t.xo = c.xo;
    t.z = z;
    const bool plane_in = DIM == 3 ? (z >= 1 && z <= g.nz) : z == 0;
    const bool tile_in = plane_in && t.y0 >= FK_ROWS_PER_BLOCK
        && t.y0 < FK_ROWS_PER_BLOCK + g.ny;
    t.oq = 0;                                        // block-uniform
    t.os = occ.s;
    if (tile_in) {
        const int b = (t.y0 - FK_ROWS_PER_BLOCK) / FK_ROWS_PER_BLOCK;
        const int zq = DIM == 3 ? z - 1 : 0;
        t.oq = min(occ.q[zq * occ.q0 + t.xo * occ.q1 + b * occ.q2], g.k);
        t.os = occ.s + zq * occ.s0 + t.xo * occ.s1 + b * occ.s2;
    }
    return t;
}

// Slot of rank r of staged cell ci of plane dz around tile t
__device__ __forceinline__ long long fr_slot(const FkTile& t,
                                             const FkGeom& g, int dz,
                                             int ci, int r) {
    const long long zs = (long long)g.n_bx * g.py;   // rows per z plane
    return r * g.cells
        + (t.row0 + dz * zs + ci / FK_STAGE_LANES - 1) * FK_LANES
        + t.lane0 - 1 + ci % FK_STAGE_LANES;
}

// Counts and offsets of the plane dz around tile t, its ranks bounded by
// kz: off[cell] the first compacted slot of each staged cell, off[cells]
// the plane's total.  Block-uniform, between its own barriers; the
// caller's barrier must separate it from earlier readers of off.
template <int KMAX>
__device__ __forceinline__ void fr_count(const float* __restrict__ X,
                                         const FkGeom& g, const FkTile& t,
                                         int dz, int kz, int* off,
                                         int* wsum) {
    const int tid = threadIdx.x;
    int n = 0;
    if (tid < FK_STAGE_CELLS) {
        const int sl = t.lane0 - 1 + tid % FK_STAGE_LANES;
        if (sl >= 0 && sl < FK_LANES) {
            const long long s = fr_slot(t, g, dz, tid, 0);
            float xr[KMAX];
#pragma unroll
            for (int r = 0; r < KMAX; ++r)
                xr[r] = r < kz ? X[r * g.cells + s] : FK_SENTINEL;
            bool run = true;
#pragma unroll
            for (int r = 0; r < KMAX; ++r) {
                run = run && xr[r] < FK_HALF_SENTINEL;
                n += run;
            }
        }
    }
    const int lt = tid & 31;
    const int w = tid >> 5;
    int incl = n;                           // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lt >= o) incl += v;
    }
    if (w < FR_SCAN_WARPS && lt == 31) wsum[w] = incl;
    __syncthreads();
    if (tid < FK_STAGE_CELLS) {
        int pre = 0;
        for (int i = 0; i < w; ++i) pre += wsum[i];
        off[tid] = pre + incl - n;
        if (tid == FK_STAGE_CELLS - 1) off[FK_STAGE_CELLS] = pre + incl;
    }
    __syncthreads();
}

// stage(i, slot) for the compacted slots w0 .. w1 - 1 of the plane dz
// around tile t, i = slot - w0: one thread a slot, its cell the last whose
// offset is not past it.  No barrier.
template <class Stage>
__device__ __forceinline__ void fr_stage(const FkTile& t, const FkGeom& g,
                                         int dz, const int* off, int w0,
                                         int w1, Stage stage) {
    for (int i = w0 + (int)threadIdx.x; i < w1; i += FK_THREADS) {
        int ci = 0;
#pragma unroll
        for (int step = 128; step > 0; step >>= 1)
            if (ci + step < FK_STAGE_CELLS && off[ci + step] <= i)
                ci += step;
        stage(i - w0, fr_slot(t, g, dz, ci, i - off[ci]));
    }
}

// pair(i - w0) for each staged slot i in w0 .. w1 - 1 of the query at tile
// row qr, lane l: its 3 x 3 cells in the order dy, dx, rank, one range of
// slots a row
template <class Pair>
__device__ __forceinline__ void fr_pairs(const int* off, int qr, int l,
                                         int w0, int w1, Pair pair) {
    for (int dy = 0; dy < 3; ++dy) {
        const int ci = (qr + dy) * FK_STAGE_LANES + l;
        const int hi = min(off[ci + 3], w1) - w0;
#pragma unroll 2
        for (int c = max(off[ci], w0) - w0; c < hi; ++c) pair(c);
    }
}
