// Kernel 3: poly6 summation density over the 3^d cell stencil.
//
// Replaces gpufluidsimulator_tpu/ops/pallas_sph.py:_density_kernel.  For
// every valid (x < SENTINEL/2) rank of an interior cell:
//   rho = poly6_coef * m * sum over the 3^d neighbour cells' valid ranks of
//         max(h^2 - r^2, 0)^3                                 (self included)
// in the order dz, dy, rank, dx (ranks in passes of FD_PASS, each pass over
// dy, at K = 16), and 0 on every other slot (the TPU kernel leaves those
// undefined; the port defines them as 0).  As the TPU kernel does, it skips
// an 8-row block whose occ_q is 0 and bounds each dz plane's ranks by occ_s
// (plane z's, which hold the queries, included); a cell's count also stops
// at its first sentinel rank.
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
// The second design (the row tile: a block of 256 threads per 4 rows x 32
// lanes of one plane, the 6 x 34 cells of each dz plane staged rank pass by
// rank pass, a row of three cells walked up to the largest of their counts
// with the rest masked) ran 11.7x this bound (0.27466 ms): every slot was
// staged about 4.8 times (by the three query planes that read it, and 1.6
// times for the tile borders), and each staged rank loaded x, y and z
// before its sentinel test, valid or not.
//
// This design: the z-marching column of csrc/ring.cuh, as the force
// kernels run it, with the row tile's walk.  A block of 256 threads marches
// FD_Z planes of one 4 x 32 tile.  It first zeroes its column's slots with
// float4 stores (fd_column_zero) and skips every plane whose occ_q is 0, so
// the empty planes, most of the card's slots, cost a store stream and one
// load of occ_q each.  Its ring holds the neighbour planes z-1, z, z+1,
// each compacted to its valid slots, one float4 (x, y, z, 0) a slot, staged
// once for every query of the column that reads it.  The queries are the
// compacted slots of plane z's interior cells, cell-major, one a thread:
// the plane's offsets give each its cell and rank and its staged slot its
// position (read from memory where the plane overflowed), so no query
// layout reads the plane again.  A query walks each row of three cells in
// the row tile's order: rank by rank, the three cells of a rank in dx
// order, each valid slot once (a mask of the row's slots, fd_rows), with
// the row tile's arithmetic, so rho is the row tile's bit for bit and no
// trajectory hangs on this kernel's design.  A plane of more than FD_CAP
// valid slots is not staged: its candidates are read from memory in the
// same order, and the plane is counted (ring_ovf).
//
// The constants are measured (H100 80GB HBM3 at 700 W, density on the
// evolved config-4 and config-5 planes, against each other in one
// process).  With a walk in the order dx, rank (one exact range of slots a
// row, rho equal to the row tile's only to rounding): FD_Z = 3 (2: +0.3%
// at config 4, +4% at config 5; 4: +2%, -2%; 1: +9%, +18%; 6 and 8: +11 to
// +17%, -1%), FD_CAP = 704 slots for 6 blocks an SM (640: the same time,
// with 3 and 31 planes a launch over it; 576 at 7 blocks and 32 registers:
// +1 to +3%; 800 and 1024 at 5 and 4 blocks: +4 to +10%), registers capped
// at 40 (no spills), the queries taken from the staged plane
// (fk_tile_queries' layout: +1 to +2%), against x, y, z of every rank
// loaded with the count in one pass (+70 to +130%: 388 B or more of
// spills) and the row tile's fill of each plane (+9 to +11%).  That walk
// ran 0.187 and 0.653 ms where the row tile ran 0.270 and 1.008.  In the
// row tile's order: this mask walk 0.254 and 0.859 ms (no spills); the
// row tile's masked walk, up to the largest count of a row, 0.263 and
// 0.907 (204 B of spills; unrolled twice 0.257 and 0.896); a walk rank by
// rank that tests each cell's count in turn 0.339 and 1.142.
#include "ring.cuh"

#define FD_Z 3                  // z planes a block marches
#define FD_CAP 704              // slots a ring plane holds: 3.5 a cell
#define FD_MIN_BLOCKS 6         // blocks an SM: caps registers at 40
#define FD_PASS 8               // ranks a pass of the row tile's sum order

// Dynamic shared memory of one block: one float4 per slot of each ring
// plane; FR_RING planes in 3D, one in 2D
template <int DIM>
__host__ __device__ constexpr int fd_stage_bytes() {
    return (DIM == 3 ? FR_RING : 1) * FD_CAP * (int)sizeof(float4);
}
static_assert(fd_stage_bytes<3>() + sizeof(FrRing) <= 48 * 1024,
              "a block fits the 48 KB of shared memory open without opt-in");

// Zero every slot of the column's tiles, one float4 of 4 lanes a store, so
// that its empty planes cost no more than their bytes; the queries' sums
// overwrite their slots after the barriers that precede them
__device__ __forceinline__ void fd_column_zero(const FkGeom& g,
                                               const FrColumn& col,
                                               float* __restrict__ rho) {
    constexpr int L4 = FK_TILE_LANES / 4;      // float4 a tile row
    const int n = (col.z1 - col.z0) * FK_TILE_ROWS * g.k * L4;
    for (int i = threadIdx.x; i < n; i += FK_THREADS) {
        const int l4 = i % L4;
        const int rr = i / L4 % FK_TILE_ROWS;
        const int rz = i / (L4 * FK_TILE_ROWS);   // rank, then plane
        const int r = rz % g.k;
        const int z = col.z0 + rz / g.k;
        const long long row = ((long long)z * g.n_bx + col.xo) * g.py
            + col.y0 + rr;
        *reinterpret_cast<float4*>(rho + r * g.cells + row * FK_LANES
                                   + col.lane0 + 4 * l4) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
}

// The ring's window lo .. hi once plane p is put in its slot p % FR_RING:
// a p next above or below the window extends it (dropping the plane that
// slot held), any other p starts a new window
__device__ __forceinline__ void fd_ring_add(int p, int& lo, int& hi) {
    if (p == hi + 1) {
        hi = p;
        lo = max(lo, p - (FR_RING - 1));
    } else if (p == lo - 1) {
        lo = p;
        hi = min(hi, p + (FR_RING - 1));
    } else {
        lo = hi = p;
    }
}

// The row tile's walk of a query's ring plane (offsets off; the query at
// tile row qr, lane l): the ranks in passes of FD_PASS, each pass over the
// rows dy, each row rank by rank, a rank's cells in dx order, each valid
// slot once: bit 3 r + dx of a row's mask is rank r of cell dx, taken
// lowest first.  visit(cell, its first compacted slot, rank).
template <int KMAX, class Visit>
__device__ __forceinline__ void fd_rows(const int* off, int qr, int l,
                                        Visit visit) {
    static_assert(FD_PASS <= 8, "a pass's mask holds 3 x 8 bits");
    for (int p0 = 0; p0 < KMAX; p0 += FD_PASS) {
        for (int dy = 0; dy < 3; ++dy) {
            const int ci = (qr + dy) * FK_STAGE_LANES + l;
            int o[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) o[i] = off[ci + i];
            unsigned m = 0u;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
                const int c = max(min(o[dx + 1] - o[dx], p0 + FD_PASS) - p0,
                                  0);
                m |= (0x249249u & ((1u << (3 * c)) - 1u)) << dx;
            }
            while (m != 0u) {
                const int b = __ffs(m) - 1;
                m &= m - 1u;
                const int r = (b * 11) >> 5;          // b / 3 for b < 24
                const int dx = b - 3 * r;
                visit(ci + dx, dx == 0 ? o[0] : dx == 1 ? o[1] : o[2],
                      p0 + r);
            }
        }
    }
}

template <int KMAX, int DIM>
__global__ void __launch_bounds__(FK_THREADS, FD_MIN_BLOCKS)
density_kernel(const float* __restrict__ pos, FkOcc occ,
               float* __restrict__ rho, int* __restrict__ ring_ovf,
               FkGeom g, float h2, float c_poly6) {
    constexpr int CAP = FD_CAP;
    extern __shared__ float4 fd_stage[];
    __shared__ FrRing ring;

    const long long cells = g.cells;
    const long long ch = (long long)g.k * cells;   // channel stride
    const float* X = pos;
    const float* Y = pos + ch;
    const float* Z = pos + 2 * ch;

    // a staged slot (valid) into ring index i: its loads in flight at once
    const auto stage = [&](int i, long long s) {
        fd_stage[i] = make_float4(X[s], Y[s], DIM == 3 ? Z[s] : 0.0f, 0.0f);
    };
    // count plane z + dz around tile t into its ring slot, bounded by kz
    const auto count = [&](const FkTile& t, int dz, int kz) {
        const int slot = DIM == 3 ? (t.z + dz) % FR_RING : 0;
        fr_count<KMAX>(X, g, t, dz, kz, ring.off[slot], ring.wsum);
    };
    // stage the counted plane z + dz, unless it overflows (counted)
    const auto fill_ring = [&](const FkTile& t, int dz) {
        const int slot = DIM == 3 ? (t.z + dz) % FR_RING : 0;
        const int* off = ring.off[slot];
        const int total = off[FK_STAGE_CELLS];
        if (total <= CAP) {
            fr_stage(t, g, dz, off, 0, total, [&](int i, long long sl) {
                stage(slot * CAP + i, sl);
            });
        } else if (threadIdx.x == 0) {
            atomicAdd(ring_ovf, 1);
        }
    };

    const FrColumn col = fr_column<FD_Z>(g);
    fd_column_zero(g, col, rho);
    // the tile's interior cells: rows 0 .. nrows - 1 of a tile whose occ_q
    // is not 0, ring lanes la .. lb - 1 (tile lane + 1)
    const int nrows = min(FK_TILE_ROWS, FK_ROWS_PER_BLOCK + g.ny - col.y0);
    const int la = max(col.lane0, 1) - col.lane0 + 1;
    const int lb = min(min(col.lane0 + FK_TILE_LANES - 1, FK_TILE_X),
                       g.nx - col.xo * FK_TILE_X) - col.lane0 + 2;
    // the ring holds the planes lo .. hi, counted and staged (none while
    // hi < lo), plane p in ring slot p % FR_RING (block-uniform)
    int lo = 0, hi = -1;
    for (int z = col.z0; z < col.z1; ++z) {
        const FkTile t = fr_tile<DIM>(g, occ, col, z);
        if (t.oq == 0 || la >= lb) continue;  // no query: the zeros stand
        // occ_s of the planes z-1, z, z+1, capped at k (0 off the plane in
        // 2D)
        int kz[3];
#pragma unroll
        for (int d = 0; d < 3; ++d)
            kz[d] = DIM == 2 && d != 1 ? 0 : min(t.os[d * occ.s3], g.k);
        __syncthreads();          // the last plane's readers are done
        // the queries: the valid slots of plane z's interior cells, one
        // range of its compacted slots a row
        const bool had_z = z >= lo && z <= hi;
        if (!had_z) {
            count(t, 0, kz[1]);
            fd_ring_add(z, lo, hi);
        }
        const int zslot = DIM == 3 ? z % FR_RING : 0;
        const int* zoff = ring.off[zslot];
        int nq = 0;
        for (int rr = 0; rr < nrows; ++rr) {
            const int c0 = (rr + 1) * FK_STAGE_LANES;
            nq += zoff[c0 + lb] - zoff[c0 + la];
        }
        if (nq == 0) {
            if (!had_z) hi = z - 1;   // z counted, not staged
            continue;
        }
        if (!had_z) fill_ring(t, 0);
        // the neighbour planes the ring lacks
        for (int dz = -1; DIM == 3 && dz <= 1; dz += 2) {
            const int p = z + dz;
            if (p >= lo && p <= hi) continue;
            count(t, dz, kz[dz + 1]);
            fd_ring_add(p, lo, hi);
            fill_ring(t, dz);
        }
        __syncthreads();

        const bool z_whole = zoff[FK_STAGE_CELLS] <= CAP;
        for (int q0 = 0; q0 < nq; q0 += FK_THREADS) {
            int j = q0 + (int)threadIdx.x;
            const bool active = j < nq;
            int qr = 0, l = 0;
            long long s = 0;
            float qx = 0.0f, qy = 0.0f, qz = 0.0f;
            if (active) {
                // its row, its compacted slot i, and the cell whose range
                // holds i
                int c0 = FK_STAGE_LANES;
                for (; qr < nrows - 1; ++qr, c0 += FK_STAGE_LANES) {
                    const int n = zoff[c0 + lb] - zoff[c0 + la];
                    if (j < n) break;
                    j -= n;
                }
                const int i = zoff[c0 + la] + j;
                int ci = c0 + la;
#pragma unroll
                for (int step = 16; step > 0; step >>= 1)
                    if (ci + step < c0 + lb && zoff[ci + step] <= i)
                        ci += step;
                l = ci - c0 - 1;
                s = (long long)(i - zoff[ci]) * cells + t.base
                    + qr * FK_LANES + l;
                if (z_whole) {
                    const float4 v = fd_stage[zslot * CAP + i];
                    qx = v.x;
                    qy = v.y;
                    qz = v.z;
                } else {
                    qx = X[s];
                    qy = Y[s];
                    if (DIM == 3) qz = Z[s];
                }
            }
            if (!active) continue;
            float acc = 0.0f;
            // a candidate, the row tile's arithmetic (its add not fused
            // with the cube, as the row tile's masked add was not)
            const auto pair = [&](const float4& v) {
                const float ddx = qx - v.x;
                const float ddy = qy - v.y;
                float r2 = ddx * ddx + ddy * ddy;
                if (DIM == 3) {
                    const float ddz = qz - v.z;
                    r2 = r2 + ddz * ddz;
                }
                const float d = fmaxf(h2 - r2, 0.0f);
                acc = __fadd_rn(acc, d * d * d);
            };
            for (int dz = (DIM == 3 ? -1 : 0); dz <= (DIM == 3 ? 1 : 0);
                 ++dz) {
                const int slot = DIM == 3 ? (z + dz) % FR_RING : 0;
                const int* off = ring.off[slot];
                if (off[FK_STAGE_CELLS] <= CAP) {
                    const float4* st = fd_stage + slot * CAP;
                    fd_rows<KMAX>(off, qr, l, [&](int, int o, int r) {
                        pair(st[o + r]);
                    });
                } else {
                    // an overflowed plane: its candidates from memory
                    fd_rows<KMAX>(off, qr, l, [&](int ci, int, int r) {
                        const long long sl = fr_slot(t, g, dz, ci, r);
                        pair(make_float4(X[sl], Y[sl],
                                         DIM == 3 ? Z[sl] : 0.0f, 0.0f));
                    });
                }
            }
            rho[s] = c_poly6 * acc;
        }
    }
}

template <int KMAX, int DIM>
static int launch_density(const float* pos, const FkOcc& occ, float* rho,
                          int* ring_ovf, const FkGeom& g, float h2,
                          float c_poly6, cudaStream_t st) {
    constexpr int bytes = fd_stage_bytes<DIM>();
    density_kernel<KMAX, DIM>
        <<<(unsigned)fr_blocks<FD_Z>(g), FK_THREADS, bytes, st>>>(
            pos, occ, rho, ring_ovf, g, h2, c_poly6);
    return (int)cudaGetLastError();
}

// occ_q, occ_s: sph.density_planes' bounds (int32, any strides); ostr:
// their 7 strides in elements, a host array; ring_ovf: the count of ring
// planes that overflowed.  One block per column of FD_Z planes of a tile
// of FK_TILE_ROWS rows x 32 lanes: the rows of a (z, x tile) plane (py of
// them, a multiple of 8) lie in whole tiles.
extern "C" int fk_density(const float* pos, const int* occ_q,
                          const int* occ_s, const long long* ostr,
                          float* rho, int* ring_ovf, int dim, int k, int nx,
                          int ny, int nz, int n_bx, int py, int pz,
                          long long cells, float h2, float c_poly6,
                          void* stream) {
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    const FkOcc occ = fk_occ_from(occ_q, occ_s, ostr);
    cudaStream_t st = (cudaStream_t)stream;
    if (cells % FK_LANES != 0 || py % FK_TILE_ROWS != 0
        || (dim != 2 && dim != 3) || k < 1 || k > 16)
        return (int)cudaErrorInvalidValue;
    if (k <= 8)
        return dim == 3
            ? launch_density<8, 3>(pos, occ, rho, ring_ovf, g, h2, c_poly6,
                                   st)
            : launch_density<8, 2>(pos, occ, rho, ring_ovf, g, h2, c_poly6,
                                   st);
    return dim == 3
        ? launch_density<16, 3>(pos, occ, rho, ring_ovf, g, h2, c_poly6, st)
        : launch_density<16, 2>(pos, occ, rho, ring_ovf, g, h2, c_poly6, st);
}
