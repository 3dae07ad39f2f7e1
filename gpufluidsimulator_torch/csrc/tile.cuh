// The row tile of the rank-plane sweeps: csrc/density.cu (kernel 3) runs
// on it whole; csrc/force.cu (kernel 4, all three modes) marches it up a
// column of z planes (csrc/ring.cuh) and takes from here the bounds
// (FkOcc), the tile (FkTile), its query layout and its fill.
//
// A block of FK_THREADS threads owns a tile of FK_TILE_ROWS rows x 32 lanes
// of one (z, x tile) plane, inside one 8-row block.  Warp w counts the
// valid ranks of row w's lanes (bounded by the block's occ_q, stopping at
// the first sentinel) and lays that row's queries out, one a thread
// (fk_tile_queries): rank-major with ballots (threads take neighbouring
// lanes of one rank) or cell-major with a lane scan (threads of one cell
// share its neighbours; both sweeps lay them out so); meanwhile one more
// warp loads the tile's occ_s for the sweep.  Every slot that holds no
// query is written by one coalesced sweep (fk_tile_fill).  A tile whose
// occ_q is 0, or that holds no interior row, has no query, so it only
// fills and stages nothing.  The density sweep stages its candidates into
// shared memory one dz plane at a time (fk_tile_sweep): a plane whose
// occ_s is 0 is skipped, the others' 6 rows x 34 lanes around the tile are
// staged one thread per slot with every load in flight at once, ranks
// below occ_s, FK_STAGE_RANKS a pass (K = 16 takes two), rank-major so a
// warp reads neighbouring cells without bank conflicts; a cell's count
// falls to its first sentinel rank.  Each thread then takes one query
// (FK_THREADS at a time) and walks its 3 x 3 staged cells of each plane.
// What a slot stages, what a pair adds and what a fill writes are the
// kernels' own (functors).
#pragma once

#include "common.cuh"

#define FK_THREADS 256          // threads a block; queries 256 at a time
#define FK_STAGE_RANKS 8        // ranks of a staged cell a pass holds
#define FK_TILE_ROWS 4          // rows of a block's tile (divides 8 and py)
#define FK_TILE_LANES 32        // lanes of each row that a block owns
#define FK_TILES_PER_ROW (FK_LANES / FK_TILE_LANES)
#define FK_STAGE_LANES (FK_TILE_LANES + 2)
#define FK_STAGE_CELLS ((FK_TILE_ROWS + 2) * FK_STAGE_LANES)  // a dz plane
static_assert(FK_THREADS % 32 == 0 && FK_THREADS / 32 > FK_TILE_ROWS,
              "a warp counts each row of the tile, one more loads occ_s");
static_assert(FK_ROWS_PER_BLOCK % FK_TILE_ROWS == 0,
              "a tile lies in one 8-row block");

// ranks of a staged cell a pass holds at cell capacity KMAX
template <int KMAX>
__host__ __device__ constexpr int fk_stage_ranks() {
    return KMAX < FK_STAGE_RANKS ? KMAX : FK_STAGE_RANKS;
}

// The occupancy bounds of sph.accel_planes / sph.density_planes, read
// through their strides (in elements): occ_q (nz|1, n_bx, n_by) bounds a
// block's query ranks and tells an empty block; occ_s (..., 3) bounds the
// ranks staged from the planes z-1, z, z+1 around it.
struct FkOcc {
    const int* q;
    const int* s;
    long long q0, q1, q2;
    long long s0, s1, s2, s3;
};

// occ_q, occ_s: the bounds' device pointers; ostr: their 7 strides in
// elements (occ_q's 3, then occ_s's 4), a host array
static inline FkOcc fk_occ_from(const int* occ_q, const int* occ_s,
                                const long long* ostr) {
    return FkOcc{occ_q, occ_s, ostr[0], ostr[1], ostr[2],
                 ostr[3], ostr[4], ostr[5], ostr[6]};
}

// A block's tile: rows row0 .. row0 + FK_TILE_ROWS - 1 (y0 ..), lanes
// lane0 .. lane0 + 31, and its bounds: oq (0 outside the interior) and os,
// its occ_s entry (plane dz + 1 at os[(dz + 1) * occ.s3])
struct FkTile {
    long long row0, base;       // first row, first cell
    int lane0, y0, xo, z;
    int oq;
    const int* os;
};

template <int DIM>
__device__ __forceinline__ FkTile fk_tile(const FkGeom& g, const FkOcc& occ) {
    FkTile t;
    t.row0 = (long long)(blockIdx.x / FK_TILES_PER_ROW) * FK_TILE_ROWS;
    t.lane0 = (int)(blockIdx.x % FK_TILES_PER_ROW) * FK_TILE_LANES;
    t.base = t.row0 * FK_LANES + t.lane0;
    t.y0 = (int)(t.row0 % g.py);
    const long long zx = t.row0 / g.py;
    t.xo = (int)(zx % g.n_bx);
    t.z = (int)(zx / g.n_bx);
    const bool plane_in = DIM == 3 ? (t.z >= 1 && t.z <= g.nz) : t.z == 0;
    const bool tile_in = plane_in && t.y0 >= FK_ROWS_PER_BLOCK
        && t.y0 < FK_ROWS_PER_BLOCK + g.ny;
    t.oq = 0;                                        // block-uniform
    t.os = occ.s;
    if (tile_in) {
        const int b = (t.y0 - FK_ROWS_PER_BLOCK) / FK_ROWS_PER_BLOCK;
        const int zq = DIM == 3 ? t.z - 1 : 0;
        t.oq = min(occ.q[zq * occ.q0 + t.xo * occ.q1 + b * occ.q2], g.k);
        t.os = occ.s + zq * occ.s0 + t.xo * occ.s1 + b * occ.s2;
    }
    return t;
}

// The query layout of a tile, in shared memory
template <int KMAX>
struct FkQueries {
    int n[FK_TILE_ROWS][FK_TILE_LANES];       // valid ranks of each cell
    unsigned short q[FK_TILE_ROWS][KMAX * FK_TILE_LANES];  // (rank<<5)|lane
    // queries of each row; occ_s of the planes dz = -1, 0, 1, capped at k
    // (shorts, so that the three bounds take no more shared memory)
    unsigned short nrow[FK_TILE_ROWS];
    unsigned short kz[3];
};

// Warp w < FK_TILE_ROWS: each lane's valid ranks in row w, and the row's
// queries, rank-major (CELL_MAJOR false: rank 0 of every lane, then rank
// 1, ...; neighbouring threads take neighbouring lanes) or cell-major
// (true: a cell's ranks next to each other, so threads that share a cell
// share its neighbours).  Warp FK_TILE_ROWS loads the tile's three occ_s
// meanwhile.  Returns the tile's query count (after a barrier).
template <int KMAX, bool CELL_MAJOR, int DIM>
__device__ __forceinline__ int fk_tile_queries(const float* __restrict__ X,
                                               const FkGeom& g,
                                               const FkTile& t,
                                               const FkOcc& occ,
                                               FkQueries<KMAX>& sq) {
    const int w = threadIdx.x >> 5;
    const int lt = threadIdx.x & (FK_TILE_LANES - 1);
    if (w == FK_TILE_ROWS && lt < 3) {
        // occ_s's plane index is dz + 1: all three in 3D, plane 1 in 2D
        sq.kz[lt] = (unsigned short)(t.oq == 0 || (DIM == 2 && lt != 1)
            ? 0 : min(t.os[lt * occ.s3], g.k));
    }
    if (w < FK_TILE_ROWS) {
        const int lane = t.lane0 + lt;
        const long long cw = t.base + w * FK_LANES + lt;
        int n = 0;
        if (t.y0 + w < FK_ROWS_PER_BLOCK + g.ny && lane >= 1
            && lane <= FK_TILE_X && t.xo * FK_TILE_X + lane - 1 < g.nx) {
            // every rank's x in flight at once; n stops at the first
            // sentinel rank
            float xr[KMAX];
#pragma unroll
            for (int r = 0; r < KMAX; ++r)
                xr[r] = r < t.oq ? X[r * g.cells + cw] : FK_SENTINEL;
            bool run = true;
#pragma unroll
            for (int r = 0; r < KMAX; ++r) {
                run = run && xr[r] < FK_HALF_SENTINEL;
                n += run;
            }
        }
        sq.n[w][lt] = n;
        if constexpr (CELL_MAJOR) {
            int incl = n;                 // inclusive scan over the lanes
#pragma unroll
            for (int o = 1; o < FK_TILE_LANES; o <<= 1) {
                const int v = __shfl_up_sync(0xffffffffu, incl, o);
                if (lt >= o) incl += v;
            }
            for (int r = 0; r < n; ++r)
                sq.q[w][incl - n + r] = (unsigned short)((r << 5) | lt);
            if (lt == FK_TILE_LANES - 1) sq.nrow[w] = (unsigned short)incl;
        } else {
            const unsigned below = (1u << lt) - 1u;
            int nq = 0;
            for (int r = 0; r < t.oq; ++r) {
                const unsigned mask = __ballot_sync(0xffffffffu, n > r);
                if (mask == 0u) break;
                if (n > r)
                    sq.q[w][nq + __popc(mask & below)] =
                        (unsigned short)((r << 5) | lt);
                nq += __popc(mask);
            }
            if (lt == 0) sq.nrow[w] = (unsigned short)nq;
        }
    }
    __syncthreads();
    int nq = 0;
#pragma unroll
    for (int rr = 0; rr < FK_TILE_ROWS; ++rr) nq += sq.nrow[rr];
    return nq;
}

// fill(slot) for every slot of the tile whose rank holds no query
template <int KMAX, class Fill>
__device__ __forceinline__ void fk_tile_fill(const FkGeom& g, const FkTile& t,
                                             const FkQueries<KMAX>& sq,
                                             Fill fill) {
    const int k = g.k;
    for (int i = threadIdx.x; i < FK_TILE_ROWS * k * FK_TILE_LANES;
         i += FK_THREADS) {
        const int rr = i / (k * FK_TILE_LANES);
        const int r = i / FK_TILE_LANES - rr * k;
        const int l = i % FK_TILE_LANES;
        if (r >= sq.n[rr][l])
            fill(r * g.cells + t.base + rr * FK_LANES + l);
    }
}

// Query j < nq of the tile: its tile row qr, lane l and slot s
struct FkQuery {
    int qr, l;
    long long s;
};

template <int KMAX>
__device__ __forceinline__ FkQuery fk_tile_query(const FkQueries<KMAX>& sq,
                                                 int j, const FkTile& t,
                                                 long long cells) {
    FkQuery q{0, 0, 0};
    while (q.qr < FK_TILE_ROWS - 1 && j >= sq.nrow[q.qr]) j -= sq.nrow[q.qr++];
    const int code = sq.q[q.qr][j];
    q.l = code & (FK_TILE_LANES - 1);
    q.s = (code >> 5) * cells + t.base + q.qr * FK_LANES + q.l;
    return q;
}

// The staged neighbour planes of a tile, one dz plane at a time, each
// bounded by kz (FkQueries::kz): a plane bounded by 0 is not staged, the
// others go in passes of SR ranks, between two barriers: stage(i, slot)
// for each slot to stage, i = r * FK_STAGE_CELLS + cell for rank r0 + r,
// loads it and returns false at a sentinel x, and the cell's count
// cnt[cell] (the plane's occ_s at the first pass) falls to that rank;
// then pairs(r0, rn) with rn the pass's ranks.  Block-uniform: every
// thread calls it.  cnt holds FK_STAGE_CELLS ints.
template <int DIM, int SR, class Stage, class Pairs>
__device__ __forceinline__ void fk_tile_sweep(const FkTile& t, const FkGeom& g,
                                              const unsigned short* kzs,
                                              int* cnt, Stage stage,
                                              Pairs pairs) {
    const int tid = threadIdx.x;
    const long long zs = (long long)g.n_bx * g.py;   // rows per z plane
    for (int dz = (DIM == 3 ? -1 : 0); dz <= (DIM == 3 ? 1 : 0); ++dz) {
        const int kz = kzs[dz + 1];                  // 0: block-uniform skip
        for (int r0 = 0; r0 < kz; r0 += SR) {
            const int rn = min(SR, kz - r0);
            __syncthreads();      // the last pass's readers are done
            if (r0 == 0) {
                for (int i = tid; i < FK_STAGE_CELLS; i += FK_THREADS)
                    cnt[i] = kz;
                __syncthreads();
            }
            // one thread per staged slot: every load in flight at once
            for (int i = tid; i < rn * FK_STAGE_CELLS; i += FK_THREADS) {
                const int r = i / FK_STAGE_CELLS;
                const int ci = i - r * FK_STAGE_CELLS;
                const int sl = t.lane0 - 1 + ci % FK_STAGE_LANES;
                if (sl < 0 || sl >= FK_LANES) {
                    cnt[ci] = 0;
                    continue;
                }
                const long long s = (r0 + r) * g.cells
                    + (t.row0 + dz * zs + ci / FK_STAGE_LANES - 1) * FK_LANES
                    + sl;
                if (!stage(i, s)) atomicMin(&cnt[ci], r0 + r);
            }
            __syncthreads();
            pairs(r0, rn);
        }
    }
}
