// The row tile of the rank-plane sweeps: csrc/force.cu (kernel 4, all
// three modes) and csrc/density.cu (kernel 3) march it up a column of z
// planes (csrc/ring.cuh) and take from here the bounds (FkOcc) and the
// tile (FkTile); the force kernels also its query layout and its fill.
//
// A tile is FK_TILE_ROWS rows x 32 lanes of one (z, x tile) plane, inside
// one 8-row block; a block of FK_THREADS threads serves it.  Warp w counts
// the valid ranks of row w's lanes (bounded by the block's occ_q, stopping
// at the first sentinel) and lays that row's queries out, one a thread,
// cell-major with a lane scan, so threads of one cell share its neighbours
// (fk_tile_queries); meanwhile one more warp loads the tile's occ_s for
// the sweep.  Every slot that holds no
// query is written by one coalesced sweep: fk_tile_fill a lane a thread
// (plain mode), fk_tile_fill4 four lanes a thread (the fused steps, which
// also need to know whether a slot's 32-byte sector, 8 lanes of a rank
// row, holds a query).  A tile whose occ_q is 0, or that holds no
// interior row, has no query, so it only fills.  What a fill writes is
// the kernels' own (functors).
#pragma once

#include "common.cuh"

#define FK_THREADS 256          // threads a block; queries 256 at a time
#define FK_TILE_ROWS 4          // rows of a block's tile (divides 8 and py)
#define FK_TILE_LANES 32        // lanes of each row that a block owns
#define FK_TILES_PER_ROW (FK_LANES / FK_TILE_LANES)
#define FK_STAGE_LANES (FK_TILE_LANES + 2)
#define FK_STAGE_CELLS ((FK_TILE_ROWS + 2) * FK_STAGE_LANES)  // a dz plane
static_assert(FK_THREADS % 32 == 0 && FK_THREADS / 32 > FK_TILE_ROWS,
              "a warp counts each row of the tile, one more loads occ_s");
static_assert(FK_ROWS_PER_BLOCK % FK_TILE_ROWS == 0,
              "a tile lies in one 8-row block");

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

// A tile: rows row0 .. row0 + FK_TILE_ROWS - 1 (y0 ..), lanes lane0 ..
// lane0 + 31, and its bounds: oq (0 outside the interior) and os,
// its occ_s entry (plane dz + 1 at os[(dz + 1) * occ.s3])
struct FkTile {
    long long row0, base;       // first row, first cell
    int lane0, y0, xo, z;
    int oq;
    const int* os;
};

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
// queries, cell-major: a cell's ranks next to each other, so threads that
// share a cell share its neighbours.  Warp FK_TILE_ROWS loads the tile's
// three occ_s meanwhile.  Returns the tile's query count (after a
// barrier).
template <int KMAX, int DIM>
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
        int incl = n;                     // inclusive scan over the lanes
#pragma unroll
        for (int o = 1; o < FK_TILE_LANES; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lt >= o) incl += v;
        }
        for (int r = 0; r < n; ++r)
            sq.q[w][incl - n + r] = (unsigned short)((r << 5) | lt);
        if (lt == FK_TILE_LANES - 1) sq.nrow[w] = (unsigned short)incl;
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

// The same slots four lanes (16 B of a plane) a thread: 8 threads a (row,
// rank) run of 32 lanes, 4 runs a warp a trip (the loop's bound and
// stride are multiples of 32, so a warp's lanes take the same trips).
// fill4(slot0, held) where none of the 4 lanes slot0 .. slot0 + 3 holds a
// query, fill(slot) for each lane without one where some do; held: the
// 4 lanes' sector (theirs and the neighbouring thread's 4) holds a query.
// Returns the sectors without a query that the calling thread's warp
// visited (the same in each of its lanes).  The slots of a run start at a
// multiple of 32, so a plane 16-byte aligned takes fill4's float4 stores.
template <int KMAX, class Fill4, class Fill>
__device__ __forceinline__ int fk_tile_fill4(const FkGeom& g,
                                             const FkTile& t,
                                             const FkQueries<KMAX>& sq,
                                             Fill4 fill4, Fill fill) {
    static_assert(FK_THREADS % 32 == 0 && FK_TILE_ROWS * 8 % 32 == 0
                  && FK_TILE_LANES == 32,
                  "a warp takes whole runs, a sector two neighbour lanes");
    const int k = g.k;
    int empty = 0;
    for (int i = threadIdx.x; i < FK_TILE_ROWS * k * 8; i += FK_THREADS) {
        const int rr = (i >> 3) / k;
        const int r = (i >> 3) - rr * k;
        const int l0 = (i & 7) * 4;
        const int* n = sq.n[rr] + l0;
        const unsigned mine = (unsigned)(r < n[0])
            | (unsigned)(r < n[1]) << 1 | (unsigned)(r < n[2]) << 2
            | (unsigned)(r < n[3]) << 3;
        const bool held =
            (mine | __shfl_xor_sync(0xffffffffu, mine, 1)) != 0u;
        empty += __popc(__ballot_sync(0xffffffffu, !held && !(i & 1)));
        const long long s0 = r * g.cells + t.base + rr * FK_LANES + l0;
        if (mine == 0u) {
            fill4(s0, held);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (!(mine >> j & 1u)) fill(s0 + j);
        }
    }
    return empty;
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
