// Kernel 9: per-cell consolidation of kept and arriving particles into K
// dense ranks.
//
// Replaces gpufluidsimulator_tpu/ops/inc.py:_consolidate_kernel (and, as
// a contract, the arrival planes that inc.py:arrival_planes builds for it
// with a second sort and route.py:_placement_kernel in its skip_empty form:
// the TPU cannot scatter, so it lays the arrivals out as ARRIVAL_K extra
// rank planes).  Here the movers arrive sorted by target cell, with a
// per-cell start table.  For each cell c:
//   (a) the kept ranks of c in rank order — valid (x < SENTINEL/2) and not
//       flagged as movers — up to the first sentinel rank: to_planes and
//       this kernel leave the ranks of every cell dense, and the fused
//       force step keeps a mover in its slot (flagged), so no valid rank
//       follows a sentinel one;
//   (b) then the first min(arrivals, ARRIVAL_K) movers of c, in sorted
//       order, read through the sort permutation from the mover rows
//       (arrival_k: ARRIVAL_K = 8, or K past 8, inc.arrival_cap);
//   (c) packed densely into ranks 0..K-1 of the 6 pos/vel planes and the
//       id plane; the ranks left empty get SENTINEL, 0 and -1;
//   (d) what did not fit is counted: max(arrivals - ARRIVAL_K, 0)
//       + max(kept + min(arrivals, ARRIVAL_K) - K, 0), the reference's
//       lost_dup + lost_rank (inc.py:660, 812);
//   (e) where asked (fill_max not null: while a profiler session records),
//       the largest count of particles any cell holds after (c), the step
//       counter cell_fill_max: a warp's maximum, one atomicMax a warp.
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
// what must be read: x up to each interior cell's first sentinel rank,
// the flag of each valid slot, the 5 other pos/vel channels and the id of
// each kept one, two start-table entries per interior cell and the taken
// mover rows with their sort index (with RHO: one more plane written, rho
// of each kept slot and channel 7 of each taken mover read).
//
// The first design ran one thread per cell through the kept loop, the
// arrival loop and the fill loop, each writing output rank n, which
// differed from lane to lane as soon as one lane skipped a slot: one store
// instruction landed in 2 to 4 rank rows, and each 32 B sector was written
// piecemeal over several instructions.  Every rank also loaded x and then
// the flag behind a branch on it, with 64-bit indices and a cell decode
// per thread: 0.40340 ms (0.47705 with RHO) against 0.13740 (0.15636).
//
// This design follows the reference's output-rank-major form.  A warp owns
// one lane row of 128 cells, four a thread (one float4 of each rank row),
// so the row's decode (y, x tile, z) is warp-uniform and a warp of ghost
// rows reads nothing; slots are 32-bit (the wrapper checks that 8 * K *
// cells fits).  Phase 1 loads x and the flag of rank r together, one
// coalesced 512 B row each, builds each cell's mask of kept ranks, and
// stops when no cell of the warp is still before its first sentinel rank.
// Phase 2 walks the output ranks d = 0..K-1 with one trip count for the
// warp: each cell takes the lowest bit left in its mask (the d-th kept
// rank), else its next arrival, else the fill value; where all four cells
// keep rank d itself (the common case) a channel is one float4 load.  Each
// of the 7 (8) store instructions then writes one full 512 B rank row,
// with a streaming hint (the kernel never reads its outputs).  Once no
// cell of the warp has a source left, the warp writes the fill rows
// without loading.  The drop count is a block sum and one atomic per
// block.
//
// Tried and measured against this one (scripts/torch_probe_consolidate.py,
// H100 80GB HBM3 at 700 W, evolved config 4): one cell a thread (32 a
// warp, 4-byte stores) took 0.2136 ms against 0.2117 here, its fill alone
// 0.179 against 0.161; a float4 load of rank d's row wherever every cell
// either keeps rank d or has no source (reading the empty cells too) was
// 13% slower.
#include <cstdint>

#include "common.cuh"

#define CON_THREADS 256
#define CON_WARPS (CON_THREADS / 32)
#define CON_FULL 0xffffffffu
#define CON_MAX_K 32              // the kept-rank mask is one 32-bit word
#define CON_CELLS 4               // cells a thread: one float4 of a row

__device__ __forceinline__ float4 con_ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// the outputs are not read again by this kernel: streaming stores
__device__ __forceinline__ void con_st4(float* p, float4 v) {
    __stcs(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ float con_get(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ void con_set(float4& v, int e, float a) {
    if (e == 0) v.x = a;
    else if (e == 1) v.y = a;
    else if (e == 2) v.z = a;
    else v.w = a;
}

template <bool RHO>
__global__ void __launch_bounds__(CON_THREADS)
consolidate_kernel(const float* __restrict__ new6,
                   const float* __restrict__ idp,
                   const float* __restrict__ rho,
                   const float* __restrict__ flag,
                   const float* __restrict__ movers, int m_cap,
                   const long long* __restrict__ order,
                   const int* __restrict__ starts,
                   float* __restrict__ out6, float* __restrict__ oid,
                   float* __restrict__ orho, int* __restrict__ dropped,
                   int* __restrict__ fill_max, FkGeom g, int arrival_k) {
    const int cells = (int)g.cells;
    const int k = g.k;
    const int ch = k * cells;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * CON_WARPS + (threadIdx.x >> 5);
    const int c0 = row * FK_LANES + lane * CON_CELLS;
    int lost = 0;
    int fill = 0;                      // the fullest cell's count, (e)
    if (row < cells / FK_LANES) {      // warp-uniform: a warp is a row
        const int y = row % g.py;
        const int zx = row / g.py;
        const int xo = zx % g.n_bx;
        const int z = zx / g.n_bx;
        const bool row_in =
            y >= FK_ROWS_PER_BLOCK && y < FK_ROWS_PER_BLOCK + g.ny
            && (g.dim == 3 ? z >= 1 && z <= g.nz : z == 0);
        bool in[CON_CELLS];
        unsigned keep[CON_CELLS];      // bit r: rank r of the cell is kept
        int a0[CON_CELLS], take[CON_CELLS], j[CON_CELLS];
#pragma unroll
        for (int e = 0; e < CON_CELLS; ++e) {
            const int l = lane * CON_CELLS + e;
            in[e] = row_in && l >= 1 && l <= FK_TILE_X
                    && xo * FK_TILE_X + l - 1 < g.nx;
            keep[e] = 0u;
            a0[e] = take[e] = j[e] = 0;
        }
        if (row_in) {
            bool open[CON_CELLS];      // before the cell's first sentinel
#pragma unroll
            for (int e = 0; e < CON_CELLS; ++e) open[e] = in[e];
            for (int r = 0; r < k; ++r) {
                const bool any = open[0] || open[1] || open[2] || open[3];
                if (!__any_sync(CON_FULL, any)) break;
                if (!any) continue;
                const float4 x = con_ld4(new6 + r * cells + c0);
                const float4 f = con_ld4(flag + r * cells + c0);
#pragma unroll
                for (int e = 0; e < CON_CELLS; ++e) {
                    if (!open[e]) continue;
                    if (con_get(x, e) < FK_HALF_SENTINEL) {
                        if (con_get(f, e) < 0.5f) keep[e] |= 1u << r;
                    } else {
                        open[e] = false;
                    }
                }
            }
            if (in[0] || in[1] || in[2] || in[3]) {
                const int4 s4 = *reinterpret_cast<const int4*>(starts + c0);
                const int st[CON_CELLS + 1] = {s4.x, s4.y, s4.z, s4.w,
                                               starts[c0 + CON_CELLS]};
#pragma unroll
                for (int e = 0; e < CON_CELLS; ++e) {
                    if (!in[e]) continue;
                    a0[e] = st[e];
                    const int na = st[e + 1] - st[e];
                    const int t = min(na, arrival_k);
                    const int room = k - __popc(keep[e]);
                    lost += na - t + max(t - room, 0);
                    take[e] = min(t, room);
                    fill = max(fill, k - room + take[e]);
                }
            }
        }
        const float4 sent4 = make_float4(FK_SENTINEL, FK_SENTINEL,
                                         FK_SENTINEL, FK_SENTINEL);
        const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 none4 = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
        for (int d = 0; d < k; ++d) {
            int srank[CON_CELLS];      // the source's rank, if kept
            int mrow[CON_CELLS];       // its mover row, if an arrival
            bool live = false, same = true;
#pragma unroll
            for (int e = 0; e < CON_CELLS; ++e) {
                srank[e] = mrow[e] = -1;
                if (keep[e] != 0u) {
                    srank[e] = __ffs(keep[e]) - 1;
                    keep[e] &= keep[e] - 1u;
                } else if (j[e] < take[e]) {
                    mrow[e] = (int)order[a0[e] + j[e]];
                    ++j[e];
                }
                live |= srank[e] >= 0 || mrow[e] >= 0;
                same &= srank[e] == d;
            }
            const int o = d * cells + c0;
            if (!__any_sync(CON_FULL, live)) {
                // no cell of the warp has a source left: the rest is fill
                for (; d < k; ++d) {
                    const int q = d * cells + c0;
                    con_st4(out6 + q, sent4);
                    con_st4(out6 + ch + q, sent4);
                    con_st4(out6 + 2 * ch + q, sent4);
                    con_st4(out6 + 3 * ch + q, zero4);
                    con_st4(out6 + 4 * ch + q, zero4);
                    con_st4(out6 + 5 * ch + q, zero4);
                    con_st4(oid + q, none4);
                    if (RHO) con_st4(orho + q, zero4);
                }
                break;
            }
            float4 v[6], vid, vrho = zero4;
            if (same) {                // the four cells keep rank d: copy
#pragma unroll
                for (int f = 0; f < 6; ++f)
                    v[f] = con_ld4(new6 + f * ch + o);
                vid = con_ld4(idp + o);
                if (RHO) vrho = con_ld4(rho + o);
            } else {
#pragma unroll
                for (int f = 0; f < 6; ++f) v[f] = f < 3 ? sent4 : zero4;
                vid = none4;
#pragma unroll
                for (int e = 0; e < CON_CELLS; ++e) {
                    if (srank[e] < 0 && mrow[e] < 0) continue;
                    const bool kept = srank[e] >= 0;
                    const int s = srank[e] * cells + c0 + e;
                    const float* base = kept ? new6 + s : movers + mrow[e];
                    const int stride = kept ? ch : m_cap;
#pragma unroll
                    for (int f = 0; f < 6; ++f)
                        con_set(v[f], e, base[f * stride]);
                    con_set(vid, e, kept ? idp[s]
                                         : movers[6 * m_cap + mrow[e]]);
                    if (RHO)
                        con_set(vrho, e, kept ? rho[s]
                                              : movers[7 * m_cap + mrow[e]]);
                }
            }
#pragma unroll
            for (int f = 0; f < 6; ++f) con_st4(out6 + f * ch + o, v[f]);
            con_st4(oid + o, vid);
            if (RHO) con_st4(orho + o, vrho);
        }
    }
    if (fill_max != nullptr) {         // block-uniform
        for (int o = 16; o > 0; o >>= 1)
            fill = max(fill, __shfl_xor_sync(CON_FULL, fill, o));
        if (lane == 0 && fill != 0) atomicMax(fill_max, fill);
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
                              int* dropped, int* fill_max, const FkGeom& g,
                              int arrival_k, void* stream) {
    // 32-bit slots: the 8 planes of K ranks, and the 8 mover channels
    if (g.k < 1 || g.k > CON_MAX_K || g.cells % FK_LANES != 0
        || 8LL * g.k * g.cells >= (1LL << 31) || 8LL * m_cap >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    // float4 rows: the planes and the start table 16-byte aligned
    const void* rows16[] = {new6, idp, rho, flag, starts, out6, oid, orho};
    for (const void* p : rows16)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
            return (int)cudaErrorInvalidValue;
    const long long rows = g.cells / FK_LANES;
    const unsigned blocks = (unsigned)((rows + CON_WARPS - 1) / CON_WARPS);
    consolidate_kernel<RHO><<<blocks, CON_THREADS, 0,
                              (cudaStream_t)stream>>>(
        new6, idp, rho, flag, movers, (int)m_cap, order, starts, out6, oid,
        orho, dropped, fill_max, g, arrival_k);
    return (int)cudaGetLastError();
}

// movers: (7, m_cap) rows x, y, z, vx, vy, vz, id; order: (m_cap,) the
// permutation that sorts them by target cell; starts: (cells + 1,) the
// first sorted row of each cell.  dropped: one int, zeroed by the caller;
// fill_max: null, or one int the kernel raises to the fullest cell's count
// (atomicMax).  k at most 32; 8 * k * cells and 8 * m_cap below 2^31.
extern "C" int fk_consolidate(const float* new6, const float* idp,
                              const float* flag, const float* movers,
                              long long m_cap, const long long* order,
                              const int* starts, float* out6, float* oid,
                              int* dropped, int* fill_max, int dim, int k,
                              int nx, int ny, int nz, int n_bx, int py,
                              int pz, long long cells, int arrival_k,
                              void* stream) {
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    return consolidate_launch<false>(new6, idp, nullptr, flag, movers, m_cap,
                                     order, starts, out6, oid, nullptr,
                                     dropped, fill_max, g, arrival_k, stream);
}

// The continuity tier's form: rho the carried density plane, movers (8,
// m_cap) with rho in row 7, orho the consolidated density plane.
extern "C" int fk_consolidate_rho(const float* new6, const float* idp,
                                  const float* rho, const float* flag,
                                  const float* movers, long long m_cap,
                                  const long long* order, const int* starts,
                                  float* out6, float* oid, float* orho,
                                  int* dropped, int* fill_max, int dim,
                                  int k, int nx, int ny, int nz, int n_bx,
                                  int py, int pz, long long cells,
                                  int arrival_k, void* stream) {
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    return consolidate_launch<true>(new6, idp, rho, flag, movers, m_cap,
                                    order, starts, out6, oid, orho, dropped,
                                    fill_max, g, arrival_k, stream);
}
