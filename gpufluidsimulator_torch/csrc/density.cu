// Kernel 3: poly6 summation density over the 3^d cell stencil.
//
// Replaces gpufluidsimulator_tpu/ops/pallas_sph.py:_density_kernel.  For
// every valid (x < SENTINEL/2) rank of an interior cell:
//   rho = poly6_coef * m * sum over the 3^d neighbour cells' valid ranks of
//         max(h^2 - r^2, 0)^3                                 (self included)
// and 0 on every other slot (the TPU kernel leaves those undefined; the port
// defines them as 0).  As the TPU kernel does, it skips an 8-row block
// whose occ_q is 0 and bounds the query ranks by occ_q and each dz plane's
// candidate ranks by occ_s; a cell's loop also stops at its first sentinel
// rank.
//
// Bound on the H100: bytes.  The output is written for every slot (K *
// cells * 4 B, 58.7 MB at the 1,197,770-particle double dam break; 0.023 ms
// at 3.35 TB/s with the valid slots read), above the pair arithmetic (13
// operations for each of ~6.9e7 candidate pairs, 0.013 ms at 67 TFLOP/s).
//
// The first design (one thread per cell, its valid query ranks in
// registers, the 27 neighbour cells walked one after another) ran 20x this
// bound (0.46470 ms on the evolved double dam break, H100 80GB HBM3 at
// 700 W): most threads held no query (0.65 particles a cell), each
// candidate's x load had to return before the sentinel test let the next
// rank load, each candidate was loaded again by each of the 27 cells that
// read it, and occ_q / occ_s were not read.
//
// This design: the row tile of csrc/tile.cuh and its staging loop, as the
// force kernel uses them (4 rows x 32 lanes a block of 256 threads, one
// query a thread, every slot without a query zeroed by one coalesced
// sweep, candidates staged once per block and dz plane), with the queries
// laid out cell-major, so the threads of one cell walk the same cells.
// A staged slot is one float4 (x, y, z, 0): 26 KB for a dz plane's pass of
// 8 ranks (no opt-in past 48 KB needed), so 7 blocks fit an SM's shared
// memory, and the registers are capped to let them.  A query walks its
// staged cells a row of three at a time, up to the row's largest count,
// with the slots past a cell's own count masked: a third of the cell
// loops, and three independent loads an iteration.  Staging all three dz
// planes of a 3D stencil at once (78 KB, one barrier pair, 2 blocks an
// SM) ran 2.0x slower, a looser register cap (6 blocks) and the force
// kernels' rank-major query order no faster (PERF.md).
#include "tile.cuh"

#define FK_DENSITY_MIN_BLOCKS 7  // blocks an SM: caps registers at 32

// Dynamic shared memory of one block: one float4 per staged slot of a pass
template <int KMAX>
__host__ __device__ constexpr int fk_density_stage_bytes() {
    return fk_stage_ranks<KMAX>() * FK_STAGE_CELLS * (int)sizeof(float4);
}

template <int KMAX, int DIM>
__global__ void __launch_bounds__(FK_THREADS, FK_DENSITY_MIN_BLOCKS)
density_kernel(const float* __restrict__ pos, FkOcc occ,
               float* __restrict__ rho, FkGeom g, float h2, float c_poly6) {
    constexpr int SR = fk_stage_ranks<KMAX>();
    extern __shared__ float4 fk_density_stage[];
    __shared__ int s_cnt[FK_STAGE_CELLS];
    __shared__ FkQueries<KMAX> sq;

    const long long cells = g.cells;
    const long long ch = (long long)g.k * cells;   // channel stride
    const float* X = pos;
    const float* Y = pos + ch;
    const float* Z = pos + 2 * ch;

    const FkTile t = fk_tile<DIM>(g, occ);
    const int nq = fk_tile_queries<KMAX, true, DIM>(X, g, t, occ, sq);
    fk_tile_fill<KMAX>(g, t, sq, [&](long long s) { rho[s] = 0.0f; });

    for (int q0 = 0; q0 < nq; q0 += FK_THREADS) {
        const int j = q0 + (int)threadIdx.x;
        const bool active = j < nq;
        FkQuery q{0, 0, 0};
        float qx = 0.0f, qy = 0.0f, qz = 0.0f;
        if (active) {
            q = fk_tile_query<KMAX>(sq, j, t, cells);
            qx = X[q.s];
            qy = Y[q.s];
            if (DIM == 3) qz = Z[q.s];
        }
        float acc = 0.0f;
        // a staged slot: its loads in flight at once
        const auto stage = [&](int i, long long s) {
            const float x = X[s];
            const float yv = Y[s], zv = DIM == 3 ? Z[s] : 0.0f;
            if (!(x < FK_HALF_SENTINEL)) return false;
            fk_density_stage[i] = make_float4(x, yv, zv, 0.0f);
            return true;
        };
        // the query's staged candidates row by row: the 3 cells of a row
        // go together up to the largest of their counts, and a slot past
        // its own cell's count (a sentinel never stored, or an earlier
        // pass's slot) is masked out
        const auto rows = [&](int r0, int rn) {
            for (int dy = 0; dy < 3; ++dy) {
                const int ci = (q.qr + dy) * FK_STAGE_LANES + q.l;
                int c[3];
#pragma unroll
                for (int dx = 0; dx < 3; ++dx)
                    c[dx] = min(s_cnt[ci + dx], r0 + rn) - r0;
                const int hi = max(c[0], max(c[1], c[2]));
                const float4* row = fk_density_stage + ci;
                for (int r = 0; r < hi; ++r) {
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx) {
                        const float4 v = row[r * FK_STAGE_CELLS + dx];
                        const float ddx = qx - v.x;
                        const float ddy = qy - v.y;
                        float r2 = ddx * ddx + ddy * ddy;
                        if (DIM == 3) {
                            const float ddz = qz - v.z;
                            r2 = r2 + ddz * ddz;
                        }
                        const float d = fmaxf(h2 - r2, 0.0f);
                        acc += r < c[dx] ? d * d * d : 0.0f;
                    }
                }
            }
        };
        fk_tile_sweep<DIM, SR>(t, g, sq.kz, s_cnt, stage,
                               [&](int r0, int rn) {
            if (active) rows(r0, rn);
        });
        if (active) rho[q.s] = c_poly6 * acc;
    }
}

template <int KMAX, int DIM>
static int launch_density(const float* pos, const FkOcc& occ, float* rho,
                          const FkGeom& g, float h2, float c_poly6,
                          cudaStream_t st) {
    constexpr int bytes = fk_density_stage_bytes<KMAX>();
    const long long blocks = g.cells / (FK_TILE_LANES * FK_TILE_ROWS);
    density_kernel<KMAX, DIM><<<(unsigned)blocks, FK_THREADS, bytes, st>>>(
        pos, occ, rho, g, h2, c_poly6);
    return (int)cudaGetLastError();
}

// The dynamic shared memory (bytes) of one density block at cell capacity
// k, -1 past 16; the kernel adds its static part
extern "C" int fk_density_smem(int k) {
    if (k < 1 || k > 16) return -1;
    return k <= 8 ? fk_density_stage_bytes<8>() : fk_density_stage_bytes<16>();
}

// occ_q, occ_s: sph.density_planes' bounds (int32, any strides); ostr:
// their 7 strides in elements, a host array.  One block per tile of
// FK_TILE_ROWS rows x 32 lanes: the rows of a (z, x tile) plane (py of
// them, a multiple of 8) lie in whole tiles.
extern "C" int fk_density(const float* pos, const int* occ_q,
                          const int* occ_s, const long long* ostr,
                          float* rho, int dim, int k, int nx, int ny, int nz,
                          int n_bx, int py, int pz, long long cells, float h2,
                          float c_poly6, void* stream) {
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    const FkOcc occ = fk_occ_from(occ_q, occ_s, ostr);
    cudaStream_t st = (cudaStream_t)stream;
    if (cells % FK_LANES != 0 || py % FK_TILE_ROWS != 0
        || (dim != 2 && dim != 3) || k < 1 || k > 16)
        return (int)cudaErrorInvalidValue;
    if (k <= 8)
        return dim == 3
            ? launch_density<8, 3>(pos, occ, rho, g, h2, c_poly6, st)
            : launch_density<8, 2>(pos, occ, rho, g, h2, c_poly6, st);
    return dim == 3
        ? launch_density<16, 3>(pos, occ, rho, g, h2, c_poly6, st)
        : launch_density<16, 2>(pos, occ, rho, g, h2, c_poly6, st);
}
