// Kernel 9: per-cell consolidation of kept and arriving particles into K
// dense ranks.
//
// Replaces gpufluidsimulator_tpu/ops/inc.py:_consolidate_kernel (and, as
// a contract, the arrival planes that inc.py:arrival_planes builds for it
// with a second sort and route.py:_placement_kernel in its skip_empty form:
// the TPU cannot scatter, so it lays the arrivals out as ARRIVAL_K extra
// rank planes).  Here the movers arrive sorted by target cell, with a
// per-cell start table, and one thread per cell c:
//   (a) takes the kept ranks of c in rank order — valid (x < SENTINEL/2)
//       and not flagged as movers — and stops at the first sentinel rank:
//       to_planes and this kernel leave the ranks of every cell dense, and
//       the fused force step keeps a mover in its slot (flagged), so no
//       valid rank follows a sentinel one;
//   (b) then the first min(arrivals, ARRIVAL_K) movers of c, in sorted
//       order, read through the sort permutation from the mover rows;
//   (c) packs them densely into ranks 0..K-1 of the 6 pos/vel planes and
//       the id plane; the ranks left empty get SENTINEL, 0 and -1;
//   (d) counts what did not fit: max(arrivals - ARRIVAL_K, 0)
//       + max(kept + min(arrivals, ARRIVAL_K) - K, 0), the reference's
//       lost_dup + lost_rank (inc.py:660, 812).
// Every cell that is not interior is written empty, which re-sanitizes the
// ghost and halo slots.
//
// With RHO (fk_consolidate_rho: the reference kernel's has_rho form, the
// continuity tier) the carried density rides along as an 8th field: read
// from the rho plane for kept ranks and from mover channel 7 (after the id
// at 6) for arrivals, written to its own output plane, 0 on empty ranks.
//
// Bound on the H100: bytes — the 7 output planes written once (7 * K *
// cells * 4 B = 411 MB at the 1,197,770-particle double dam break) plus
// what the loop reads: x up to each interior cell's first sentinel rank,
// the flag of each valid slot, the 5 other pos/vel channels and the id of
// each kept one, two start-table entries per interior cell and the taken
// mover rows with their sort index.  chip_smoke.py counts exactly these
// on its data (with RHO: one more plane written, rho of each kept slot and
// channel 7 of each taken mover read).  Design: a warp is 32 neighbouring
// cells, so every plane
// access of one rank is one coalesced row; only the rare arrivals are
// scattered reads.  The drop count is a block sum and one atomic per block.
#include "common.cuh"

#define CON_THREADS 256

template <bool RHO>
__global__ void __launch_bounds__(CON_THREADS)
consolidate_kernel(const float* __restrict__ new6,
                   const float* __restrict__ idp,
                   const float* __restrict__ rho,
                   const float* __restrict__ flag,
                   const float* __restrict__ movers, long long m_cap,
                   const long long* __restrict__ order,
                   const int* __restrict__ starts,
                   float* __restrict__ out6, float* __restrict__ oid,
                   float* __restrict__ orho, int* __restrict__ dropped,
                   FkGeom g, int arrival_k) {
    const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const long long cells = g.cells;
    const int k = g.k;
    const long long ch = (long long)k * cells;
    int n = 0, lost = 0;
    if (c < cells && fk_interior(c, g)) {
        for (int r = 0; r < k; ++r) {
            const long long s = (long long)r * cells + c;
            if (!(new6[s] < FK_HALF_SENTINEL)) break;
            if (flag[s] > 0.5f) continue;
            const long long d = (long long)n * cells + c;
#pragma unroll
            for (int f = 0; f < 6; ++f) out6[f * ch + d] = new6[f * ch + s];
            oid[d] = idp[s];
            if (RHO) orho[d] = rho[s];
            ++n;
        }
        const int a0 = starts[c];
        const int na = starts[c + 1] - a0;
        const int take = min(na, arrival_k);
        lost += na - take;
        for (int j = 0; j < take; ++j) {
            if (n >= k) {
                ++lost;
                continue;
            }
            const long long row = order[a0 + j];
            const long long d = (long long)n * cells + c;
#pragma unroll
            for (int f = 0; f < 6; ++f)
                out6[f * ch + d] = movers[f * m_cap + row];
            oid[d] = movers[6 * m_cap + row];
            if (RHO) orho[d] = movers[7 * m_cap + row];
            ++n;
        }
    }
    if (c < cells) {
        for (int r = n; r < k; ++r) {
            const long long d = (long long)r * cells + c;
            out6[d] = FK_SENTINEL;
            out6[ch + d] = FK_SENTINEL;
            out6[2 * ch + d] = FK_SENTINEL;
            out6[3 * ch + d] = 0.0f;
            out6[4 * ch + d] = 0.0f;
            out6[5 * ch + d] = 0.0f;
            oid[d] = -1.0f;
            if (RHO) orho[d] = 0.0f;
        }
    }
    const int total = fk_block_sum(lost);
    if (threadIdx.x == 0 && total != 0) atomicAdd(dropped, total);
}

template <bool RHO>
static int consolidate_launch(const float* new6, const float* idp,
                              const float* rho, const float* flag,
                              const float* movers, long long m_cap,
                              const long long* order, const int* starts,
                              float* out6, float* oid, float* orho,
                              int* dropped, const FkGeom& g, int arrival_k,
                              void* stream) {
    const unsigned blocks =
        (unsigned)((g.cells + CON_THREADS - 1) / CON_THREADS);
    consolidate_kernel<RHO><<<blocks, CON_THREADS, 0,
                              (cudaStream_t)stream>>>(
        new6, idp, rho, flag, movers, m_cap, order, starts, out6, oid, orho,
        dropped, g, arrival_k);
    return (int)cudaGetLastError();
}

// movers: (7, m_cap) rows x, y, z, vx, vy, vz, id; order: (m_cap,) the
// permutation that sorts them by target cell; starts: (cells + 1,) the
// first sorted row of each cell.  dropped: one int, zeroed by the caller.
extern "C" int fk_consolidate(const float* new6, const float* idp,
                              const float* flag, const float* movers,
                              long long m_cap, const long long* order,
                              const int* starts, float* out6, float* oid,
                              int* dropped, int dim, int k, int nx, int ny,
                              int nz, int n_bx, int py, int pz,
                              long long cells, int arrival_k, void* stream) {
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    return consolidate_launch<false>(new6, idp, nullptr, flag, movers, m_cap,
                                     order, starts, out6, oid, nullptr,
                                     dropped, g, arrival_k, stream);
}

// The continuity tier's form: rho the carried density plane, movers (8,
// m_cap) with rho in row 7, orho the consolidated density plane.
extern "C" int fk_consolidate_rho(const float* new6, const float* idp,
                                  const float* rho, const float* flag,
                                  const float* movers, long long m_cap,
                                  const long long* order, const int* starts,
                                  float* out6, float* oid, float* orho,
                                  int* dropped, int dim, int k, int nx,
                                  int ny, int nz, int n_bx, int py, int pz,
                                  long long cells, int arrival_k,
                                  void* stream) {
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    return consolidate_launch<true>(new6, idp, rho, flag, movers, m_cap,
                                    order, starts, out6, oid, orho, dropped,
                                    g, arrival_k, stream);
}
