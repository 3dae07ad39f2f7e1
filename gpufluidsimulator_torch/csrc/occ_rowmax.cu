// Kernel 1: per-row maximum cell occupancy, and from it the sweeps'
// occupancy bounds.
//
// Replaces gpufluidsimulator_tpu/ops/planes.py:_occ_rowmax_kernel, and the
// pooling that planes.py:occupancy_bounds runs on its result.  For each
// (z, x-tile, y) row of 128 lanes: count the ranks k < K with
// x[k, row, lane] < SENTINEL/2, then take the max over the lanes.  Ranks
// are dense (build_planes and the incremental consolidate fill them from
// 0), so the count stops at a cell's first sentinel rank.  When asked
// (occupancy_bounds), the same launch also writes the bounds:
//   occ_q[z', xo, b]    = max of the rows of interior 8-row block b,
//   occ_s[z', xo, b, j] = slab[z' + j] in 3D ((0, slab, 0) in 2D), where
//   slab = max(occ_q's rows, row y0-1, row y0+8) of a plane and z' counts
//   the interior planes (z = z' + 1).
//
// Bound on the H100: bytes — x up to each cell's first sentinel rank and
// the row maxima written (12.2 MB at the evolved 1,197,770-particle double
// dam break, of 58.7 MB of x planes); one compare per element read.
//
// The first design ran one 128-thread block per row, one lane a thread:
// each thread walked a dependent probe chain down its cell's ranks, then
// the block ran two shuffle trees and a barrier for one store.  Some 7
// waves of threads each waited through about two serial DRAM round trips
// (0.0195 ms of device time inside a step, 0.0103 in a loop of calls that
// finds the plane in L2, against 0.00364), and the bounds took about seven
// more small launches.
//
// This design: one block per 8-row y block of a plane and x tile, a warp
// per row, four lanes a thread read as one float4, so a warp's read of a
// rank is one 512 B row.  Each thread issues its first OCC_PROBE ranks'
// loads together before it compares any of them, and continues two ranks
// a load round only where a cell is still valid.  Two more warps of an
// interior block read the edge rows y0-1 and y0+8 (rows of the
// neighbouring blocks, read again), so the block has its slab without
// waiting on another block: it writes occ_q and its slab into the three
// occ_s entries that read it.  One launch yields the row maxima or the
// bounds.  Measured against it (scripts/torch_probe_consolidate.py, H100
// 80GB HBM3 at 700 W, evolved config 4, L2 flushed): one rank a round
// after the probe 0.0150 ms against 0.0142; eight lanes a thread (a half
// warp a row, fewer waves) 0.0153.
#include <cstdint>

#include "common.cuh"

#define OCC_WARPS (FK_ROWS_PER_BLOCK + 2)   // 8 rows + the 2 edge rows
#define OCC_PROBE 2                         // ranks loaded before a compare
#define OCC_FULL 0xffffffffu

// leading valid ranks of one cell: open while no sentinel rank was seen
__device__ __forceinline__ void occ_count(float x, bool& open, int& n) {
    if (open && x < FK_HALF_SENTINEL)
        ++n;
    else
        open = false;
}

__global__ void __launch_bounds__(OCC_WARPS * 32)
occ_rowmax_kernel(const float* __restrict__ x, int* __restrict__ rowmax,
                  int* __restrict__ occ_q, int* __restrict__ occ_s, int dim,
                  int k, int nz, int n_bx, int py, int n_by, int cells) {
    __shared__ int wmax[OCC_WARPS];
    const int nblk = py / FK_ROWS_PER_BLOCK;
    const int blk = blockIdx.x % nblk;           // y block of the plane
    const int zx = blockIdx.x / nblk;            // z * n_bx + x tile
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const bool interior = blk >= 1 && blk <= n_by;
    const int y = w < FK_ROWS_PER_BLOCK ? blk * FK_ROWS_PER_BLOCK + w
                  : w == FK_ROWS_PER_BLOCK ? blk * FK_ROWS_PER_BLOCK - 1
                                           : (blk + 1) * FK_ROWS_PER_BLOCK;
    int cnt = 0;
    if (w < FK_ROWS_PER_BLOCK || (interior && occ_q != nullptr)) {
        const int rs = cells / 4;                // a rank, in float4
        const float4* p =
            reinterpret_cast<const float4*>(x + (zx * py + y) * FK_LANES)
            + lane;
        float4 v[OCC_PROBE];
#pragma unroll
        for (int r = 0; r < OCC_PROBE; ++r)
            v[r] = r < k ? __ldg(p + r * rs)
                         : make_float4(FK_SENTINEL, FK_SENTINEL, FK_SENTINEL,
                                       FK_SENTINEL);
        bool o0 = true, o1 = true, o2 = true, o3 = true;
        int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
#pragma unroll
        for (int r = 0; r < OCC_PROBE; ++r) {
            occ_count(v[r].x, o0, n0);
            occ_count(v[r].y, o1, n1);
            occ_count(v[r].z, o2, n2);
            occ_count(v[r].w, o3, n3);
        }
        // then two ranks a load round where a cell is still valid
        for (int r = OCC_PROBE; r < k && (o0 || o1 || o2 || o3); r += 2) {
            const float4 t = __ldg(p + r * rs);
            const float4 u = r + 1 < k ? __ldg(p + (r + 1) * rs)
                                       : make_float4(FK_SENTINEL,
                                                     FK_SENTINEL,
                                                     FK_SENTINEL,
                                                     FK_SENTINEL);
            occ_count(t.x, o0, n0);
            occ_count(t.y, o1, n1);
            occ_count(t.z, o2, n2);
            occ_count(t.w, o3, n3);
            occ_count(u.x, o0, n0);
            occ_count(u.y, o1, n1);
            occ_count(u.z, o2, n2);
            occ_count(u.w, o3, n3);
        }
        cnt = max(max(n0, n1), max(n2, n3));
        for (int o = 16; o > 0; o >>= 1)
            cnt = max(cnt, __shfl_xor_sync(OCC_FULL, cnt, o));
    }
    if (lane == 0) wmax[w] = cnt;
    __syncthreads();
    const int t = threadIdx.x;
    if (rowmax != nullptr && t < FK_ROWS_PER_BLOCK)
        rowmax[zx * py + blk * FK_ROWS_PER_BLOCK + t] = wmax[t];
    if (occ_q == nullptr || !interior || t != 0) return;
    int q = 0;
#pragma unroll
    for (int i = 0; i < FK_ROWS_PER_BLOCK; ++i) q = max(q, wmax[i]);
    const int slab = max(q, max(wmax[FK_ROWS_PER_BLOCK],
                                wmax[FK_ROWS_PER_BLOCK + 1]));
    const int xo = zx % n_bx;
    const int z = zx / n_bx;
    const int b = blk - 1;
    if (dim == 3) {
        if (z >= 1 && z <= nz) occ_q[((z - 1) * n_bx + xo) * n_by + b] = q;
        // plane z is the (z-1) entry of plane z+1, the z entry of plane z
        // and the (z+1) entry of plane z-1; j indexes the entry
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int zq = z - j;                // interior plane zq + 1
            if (zq >= 0 && zq < nz)
                occ_s[((zq * n_bx + xo) * n_by + b) * 3 + j] = slab;
        }
    } else {
        const int e = xo * n_by + b;
        occ_q[e] = q;
        occ_s[e * 3] = 0;
        occ_s[e * 3 + 1] = slab;
        occ_s[e * 3 + 2] = 0;
    }
}

// x: (K, pz, n_bx, py, 128) x-channel planes, 16-byte aligned.  rowmax:
// (pz, n_bx, py) or null; occ_q: (nz|1, n_bx, n_by) and occ_s: (nz|1,
// n_bx, n_by, 3), both or neither (then rowmax is required).
extern "C" int fk_occ_rowmax(const float* x, int* rowmax, int* occ_q,
                             int* occ_s, int dim, int k, int nz, int n_bx,
                             int py, int pz, int n_by, long long cells,
                             void* stream) {
    if (k < 1 || py % FK_ROWS_PER_BLOCK != 0
        || cells != (long long)pz * n_bx * py * FK_LANES
        || (long long)k * cells >= (1LL << 31)
        || (occ_q == nullptr) != (occ_s == nullptr)
        || (occ_q == nullptr && rowmax == nullptr)
        || py < (n_by + 2) * FK_ROWS_PER_BLOCK
        || reinterpret_cast<uintptr_t>(x) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)pz * n_bx * (py / FK_ROWS_PER_BLOCK);
    if (blocks > 0)
        occ_rowmax_kernel<<<(unsigned)blocks, OCC_WARPS * 32, 0,
                            (cudaStream_t)stream>>>(
            x, rowmax, occ_q, occ_s, dim, k, nz, n_bx, py, n_by, (int)cells);
    return (int)cudaGetLastError();
}
