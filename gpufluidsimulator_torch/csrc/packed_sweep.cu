// Kernel 10: the packed-pair force sweep.
//
// Replaces gpufluidsimulator_tpu/ops/mxu_sweep.py:_sweep_kernel.  Particles
// are packed dense in sorted cell-id order as rows of 8 floats
// [x, y, z, vx, vy, vz, a = p/rho^2, ir = 1/rho]; each tile of 128
// consecutive rows (a query tile) has three candidate ranges [lo, hi) in
// desc (ops/mxu_sweep.py build_desc).  For each query row i:
//   a_i = k1 sum_j (a_j + a_i) d^2 rinv (x_i - x_j)
//       + k2 sum_j ir_j ir_i d (v_j - v_i)
// over the candidates j in its tile's ranges with r^2 > 1e-16, where
// d = max(h - r, 0) and rinv = rsqrt(max(r^2, 1e-24)).  Pad rows (i >= n)
// get 0.
//
// The TPU kernel walks a (query tile, slot) grid in order, accumulating
// 128 x 128 pair tiles in VMEM scratch across grid steps, with the slots'
// candidate tiles fetched by scalar-prefetch index maps, and centers the
// coordinates per tile because it splits the sum as x_i sum(c) - sum(c x_j).
// None of that carries over.
//
// Bound on the H100: operations (the distance test of every candidate
// pair).  A tile's ranges run from the end of row y - 1 through all of row
// y to the start of row y + 1 in each dz band: about 20 times the 27-cell
// candidates, and under 1% of the pairs they cover lie inside the support.
// A pair outside the support adds exactly 0, so the design tests far fewer:
//
//  * One block of 8 warps per query tile.  It stages the tile's ranges
//    (rows, split into their two float4 halves, and their cell ids) into
//    shared memory with cp.async, all loads of a window of FK_PS_WINDOW
//    rows in flight at once, so each row is read from L2 once per tile.
//    It sets its groups up while the first window's copies are in flight.
//    Four blocks fit on an SM, so one stages while the others sweep.
//  * Groups of FK_PS_QPW = 8 consecutive queries, 4 candidate lanes per
//    query, taken by the warps as they come free.  A group knows the
//    (y, z) rows its queries occupy and their x extents [x_lo, x_hi]; for
//    each neighbour row (y + dy, z + dz) that they reach, it walks once
//    the staged rows of the cells x_lo - 1 .. x_hi + 1 (the hull over the
//    group's rows that reach it), found by binary search on the staged
//    cell ids, two lanes per neighbour row.  With cells at least h wide
//    (halfwidth 1, which the wrapper checks) every row left out is two or
//    more cells from each query on some axis, as the 27-cell force and
//    density sweeps leave it out: at least h away, but for the cells that
//    halfwidth 1 takes down to h / (1 + 1e-6) and a particle that float32
//    binning puts a few ulps across a face.  Such a pair, which the plain
//    version adds when the tile's ranges hold it, has d = h - r near
//    1e-6 h (ops/mxu_sweep.py group_segments).
//  * Of those rows it keeps the ones within h of the group's bounding box
//    (a row farther away is that far from each query: group_candidates),
//    as a list of staged indices, and sweeps them every 4th to a lane;
//    the four partial sums of a query are added with shuffles, and into
//    the query's sum in shared memory, window after window.
//
// The sums are float32 in the direct form sum c (x_i - x_j), which needs
// no centering; their order is fixed, so the kernel is deterministic.
#include "common.cuh"

#define FK_TQ 128                            // queries per tile (desc row)
#define FK_PS_QPW 8                          // queries per group
#define FK_PS_LPQ (32 / FK_PS_QPW)           // candidate lanes per query
#define FK_PS_GROUPS (FK_TQ / FK_PS_QPW)     // groups per tile
#define FK_PS_WARPS 8                        // warps per block (tile)
#define FK_PS_WINDOW 1280                    // rows staged at a time
#define FK_PS_PASS 16                        // neighbour rows per pass
#define FK_PS_CHUNK 128                      // kept rows per sweep
// a row at squared distance >= h^2 (1 + 1e-4) from the group's bounding
// box is at least that far from each query: r2 * rsqrt(r2) has a relative
// error near 1e-6, so its d is exactly 0
#define FK_PS_BOX_MARGIN 1.0001f

// One query group: the (y, z) rows of its real queries and their x
// extents, their count m, and the queries' bounding box.
struct PsGroup {
    int row[FK_PS_QPW], xlo[FK_PS_QPW], xhi[FK_PS_QPW];
    int m;
    float blo[3], bhi[3];
};

// One warp's tables of a pass: the staged ranges (seg_end: running row
// count after each range; seg_base: staged index less that count's start,
// so idx = t + seg_base) and the staged indices of the rows it keeps.
struct PsWarp {
    int seg_end[FK_PS_PASS], seg_base[FK_PS_PASS];
    int kept[FK_PS_CHUNK];
};

// Dynamic shared memory of a block: the staged rows (their first and
// second float4 in two arrays), their cell ids, the tile's groups, the
// warps' tables, the queries' sums and the next group to take.
constexpr int ps_smem_bytes() {
    return FK_PS_WINDOW * (2 * (int)sizeof(float4) + (int)sizeof(int))
           + FK_PS_GROUPS * (int)sizeof(PsGroup)
           + FK_PS_WARPS * (int)sizeof(PsWarp)
           + 3 * FK_TQ * (int)sizeof(float) + (int)sizeof(int);
}

// True iff d (a difference of row indices, row = y + z * py) is one of
// the nine (dy, dz) row offsets dy + dz * py.
__device__ __forceinline__ bool ps_adjacent(int d, int py) {
    return abs(d) <= 1 || abs(d - py) <= 1 || abs(d + py) <= 1;
}

// First index in [0, len) whose sorted value is not below v (>= v; with
// upper, > v), or len.
__device__ __forceinline__ int ps_search(const int* c, int len, int v,
                                         bool upper) {
    int lo = 0, hi = len;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int x = c[mid];
        if (x < v || (upper && x == v)) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Inclusive prefix sum over the warp.
__device__ __forceinline__ int ps_scan(int v, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    return v;
}

// Asynchronous copies global -> shared (cp.async), and the wait for all of
// a thread's copies.
__device__ __forceinline__ void ps_copy16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void ps_copy4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void ps_copy_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile's three ranges as one sequence of rows.
struct PsRanges {
    int lo0, lo1, lo2, len0, len1, total;

    __device__ __forceinline__ long long at(int q) const {
        return q < len0 ? lo0 + q
               : q < len0 + len1 ? lo1 + (q - len0)
               : lo2 + (q - len0 - len1);
    }
};

// Start the copies of the staged rows [w0, w0 + wn) (first halves to
// rows[0, W), second halves to rows[W, 2 W)) and their cell ids.
__device__ __forceinline__ void ps_stage(float4* rows, int* rcid,
                                         const float4* f, const int* cids,
                                         const PsRanges& rg, int w0, int wn) {
    for (int p = threadIdx.x; p < 2 * wn; p += blockDim.x) {
        const int q = p >> 1;
        const long long j = rg.at(w0 + q);
        ps_copy16(rows + (p & 1) * FK_PS_WINDOW + q, f + 2 * j + (p & 1));
        if ((p & 1) == 0) ps_copy4(rcid + q, cids + j);
    }
}

// A group's rows (runs of one row among its real queries, sorted) and its
// bounding box, from the warp: lane = candidate lane * QPW + query.
__device__ __forceinline__ void ps_setup(PsGroup& g, const float4* f,
                                         const int* cids, int i, int n,
                                         int sy, int lane) {
    const unsigned full = 0xffffffffu;
    const int qi = lane % FK_PS_QPW;
    const int kk = lane / FK_PS_QPW;
    const bool real = i < n;
    const int c = real ? __ldg(cids + i) : 0;
    const float4 qa = __ldg(f + 2 * (long long)i);
    const int row = c / sy;
    const int x = c - row * sy;
    const int prev = __shfl_up_sync(full, row, 1, FK_PS_QPW);
    const int next = __shfl_down_sync(full, row, 1, FK_PS_QPW);
    const bool first = real && (qi == 0 || prev != row);
    const bool last = real && (qi == FK_PS_QPW - 1 || i + 1 >= n
                               || next != row);
    const unsigned qmask = FK_PS_QPW == 32 ? full
                                           : (1u << FK_PS_QPW) - 1u;
    const unsigned firsts = __ballot_sync(full, first) & qmask;
    if (kk == 0 && first) {
        const int k = __popc(firsts & ((1u << qi) - 1u));
        g.row[k] = row;
        g.xlo[k] = x;
    }
    if (kk == 0 && last) g.xhi[__popc(firsts & ((2u << qi) - 1u)) - 1] = x;
    float b[6] = {real ? qa.x : 3e38f, real ? qa.y : 3e38f,
                  real ? qa.z : 3e38f, real ? -qa.x : 3e38f,
                  real ? -qa.y : 3e38f, real ? -qa.z : 3e38f};
#pragma unroll
    for (int o = 1; o < FK_PS_QPW; o <<= 1)
#pragma unroll
        for (int a = 0; a < 6; ++a)
            b[a] = fminf(b[a], __shfl_xor_sync(full, b[a], o));
    if (lane == 0) {
        g.m = __popc(firsts);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            g.blo[a] = b[a];
            g.bhi[a] = -b[3 + a];
        }
    }
}

// One group's sum over the staged window of wn rows, into ax, ay, az.
__device__ __forceinline__ void ps_sweep(const PsGroup& g, PsWarp& s,
                                         const float4* rows, const int* rcid,
                                         int wn, int sy, int py, float h,
                                         float k1, float4 qa, float4 qb,
                                         float kir, int lane, float& ax,
                                         float& ay, float& az) {
    const unsigned full = 0xffffffffu;
    const int kk = lane / FK_PS_QPW;
    const int m = g.m;
    const float hbox2 = h * h * FK_PS_BOX_MARGIN;
    const float blx = g.blo[0], bly = g.blo[1], blz = g.blo[2];
    const float bhx = g.bhi[0], bhy = g.bhi[1], bhz = g.bhi[2];
    for (int e0 = 0; e0 < 9 * m; e0 += FK_PS_PASS) {
        // two lanes per (row k, dy, dz) entry (the range's start, its
        // end): the staged range of the neighbour row's cells, if this
        // is the first of the group's rows to reach it
        const int e = e0 + (lane & 15);
        const bool upper = lane >= 16;
        int bound = 0;
        bool lead = false;
        if (e < 9 * m) {
            const int k = e / 9;
            const int o = e - 9 * k;
            const int nr = g.row[k] + (o % 3 - 1) + (o / 3 - 1) * py;
            lead = true;
            for (int k2 = 0; k2 < k; ++k2)
                lead &= !ps_adjacent(nr - g.row[k2], py);
            if (lead) {
                int lo = g.xlo[k], hi = g.xhi[k];
                for (int k2 = k + 1; k2 < m; ++k2)
                    if (ps_adjacent(nr - g.row[k2], py)) {
                        lo = min(lo, g.xlo[k2]);
                        hi = max(hi, g.xhi[k2]);
                    }
                bound = ps_search(rcid, wn, upper ? nr * sy + hi + 1
                                                  : nr * sy + lo - 1, upper);
            }
        }
        const int b = __shfl_down_sync(full, bound, 16);
        const int len = lead && !upper ? b - bound : 0;
        const int run = ps_scan(len, lane);
        const int total = __shfl_sync(full, run, 31);
        const unsigned nonempty = __ballot_sync(full, len > 0);
        if (len > 0) {
            const int slot = __popc(nonempty & ((1u << lane) - 1u));
            s.seg_base[slot] = bound - (run - len);
            s.seg_end[slot] = run;
        }
        __syncwarp();

        // the rows of those ranges a lane each; the ones within h of the
        // bounding box listed, and swept once FK_PS_CHUNK - 32 or all are
        // in, every 4th to a lane.  Branch-free: a pair outside the
        // support (or r^2 <= 1e-16) has both coefficients 0.
        int sg = 0;                           // range of the lane's next row
        int listed = 0;
        for (int c0 = 0; c0 < total; c0 += 32) {
            const int tt = c0 + lane;
            int idx = 0;
            bool keep = false;
            if (tt < total) {
                while (tt >= s.seg_end[sg]) ++sg;
                idx = tt + s.seg_base[sg];
                const float4 ra = rows[idx];
                const float ex = fmaxf(fmaxf(blx - ra.x, ra.x - bhx), 0.f);
                const float ey = fmaxf(fmaxf(bly - ra.y, ra.y - bhy), 0.f);
                const float ez = fmaxf(fmaxf(blz - ra.z, ra.z - bhz), 0.f);
                keep = ex * ex + ey * ey + ez * ez < hbox2;
            }
            const unsigned kept = __ballot_sync(full, keep);
            if (keep)
                s.kept[listed + __popc(kept & ((1u << lane) - 1u))] = idx;
            listed += __popc(kept);
            if (listed <= FK_PS_CHUNK - 32 && c0 + 32 < total) continue;
            __syncwarp();
#pragma unroll 2
            for (int k = kk; k < listed; k += FK_PS_LPQ) {
                const int r = s.kept[k];
                const float4 ca = rows[r];
                const float4 cb = rows[FK_PS_WINDOW + r];
                const float dx = qa.x - ca.x;
                const float dy = qa.y - ca.y;
                const float dz = qa.z - ca.z;
                const float r2 = dx * dx + dy * dy + dz * dz;
                const float rinv = rsqrtf(fmaxf(r2, 1e-24f));
                float d = fmaxf(h - r2 * rinv, 0.f);
                d = r2 > 1e-16f ? d : 0.f;
                const float cp = k1 * (cb.z + qb.z) * (d * d) * rinv;
                const float cv = kir * cb.w * d;
                ax += cp * dx + cv * (ca.w - qa.w);
                ay += cp * dy + cv * (cb.x - qb.x);
                az += cp * dz + cv * (cb.y - qb.y);
            }
            __syncwarp();
            listed = 0;
        }
    }
}

__global__ void __launch_bounds__(32 * FK_PS_WARPS, 4)
packed_sweep_kernel(const float4* __restrict__ f, const int* __restrict__ cids,
                    const int* __restrict__ desc, float* __restrict__ out,
                    int n, int sy, int py, float h, float k1, float k2) {
    extern __shared__ float4 ps_smem[];
    float4* rows = ps_smem;                             // 2 per staged row
    int* rcid = (int*)(ps_smem + 2 * FK_PS_WINDOW);     // their cell ids
    PsGroup* groups = (PsGroup*)(rcid + FK_PS_WINDOW);
    PsWarp& s = ((PsWarp*)(groups + FK_PS_GROUPS))[threadIdx.x >> 5];
    float* sums = (float*)((PsWarp*)(groups + FK_PS_GROUPS) + FK_PS_WARPS);
    int* next_group = (int*)(sums + 3 * FK_TQ);
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int qi = lane % FK_PS_QPW;          // query of the group
    const int kk = lane / FK_PS_QPW;          // candidate lane
    const int base = blockIdx.x * FK_TQ;

    const int* dt = desc + blockIdx.x * 8;
    PsRanges rg;
    rg.lo0 = __ldg(dt);
    rg.lo1 = __ldg(dt + 2);
    rg.lo2 = __ldg(dt + 4);
    rg.len0 = max(__ldg(dt + 1) - rg.lo0, 0);
    rg.len1 = max(__ldg(dt + 3) - rg.lo1, 0);
    rg.total = rg.len0 + rg.len1 + max(__ldg(dt + 5) - rg.lo2, 0);

    // the first window's copies in flight while the groups are set up
    ps_stage(rows, rcid, f, cids, rg, 0, min(FK_PS_WINDOW, rg.total));
    for (int g = threadIdx.x >> 5; g < FK_PS_GROUPS; g += FK_PS_WARPS)
        ps_setup(groups[g], f, cids, base + g * FK_PS_QPW + qi, n, sy, lane);
    for (int q = threadIdx.x; q < 3 * FK_TQ; q += blockDim.x) sums[q] = 0.f;

    for (int w0 = 0; w0 < rg.total; w0 += FK_PS_WINDOW) {
        if (w0 > 0) {
            __syncthreads();                  // the last window is done
            ps_stage(rows, rcid, f, cids, rg, w0,
                     min(FK_PS_WINDOW, rg.total - w0));
        }
        if (threadIdx.x == 0) *next_group = 0;
        ps_copy_wait();
        __syncthreads();
        const int wn = min(FK_PS_WINDOW, rg.total - w0);
        // the groups go to the warps as they come free; each group's sum
        // of a window is added to its queries' sums by one warp, window
        // after window: the order is fixed
        for (;;) {
            int g = 0;
            if (lane == 0) g = atomicAdd(next_group, 1);
            g = __shfl_sync(full, g, 0);
            if (g >= FK_PS_GROUPS) break;
            const long long i = base + g * FK_PS_QPW + qi;
            const float4 qa = __ldg(f + 2 * i);
            const float4 qb = __ldg(f + 2 * i + 1);
            float ax = 0.f, ay = 0.f, az = 0.f;
            ps_sweep(groups[g], s, rows, rcid, wn, sy, py, h, k1, qa, qb,
                     k2 * qb.w, lane, ax, ay, az);
#pragma unroll
            for (int o = FK_PS_QPW; o < 32; o <<= 1) {
                ax += __shfl_xor_sync(full, ax, o);
                ay += __shfl_xor_sync(full, ay, o);
                az += __shfl_xor_sync(full, az, o);
            }
            float* sq = sums + 3 * (g * FK_PS_QPW + qi);
            for (int a = kk; a < 3; a += FK_PS_LPQ)
                sq[a] += a == 0 ? ax : a == 1 ? ay : az;
        }
    }
    __syncthreads();
    // pad rows (i >= n) get 0
    for (int q = threadIdx.x; q < 3 * FK_TQ; q += blockDim.x)
        out[3 * (long long)base + q] = base + q / 3 < n ? sums[q] : 0.f;
}

// Dynamic shared memory of a block (scripts/torch_probe_packed.py's
// report), and the pruning policy that ops/mxu_sweep.py's GROUP and
// BOX_MARGIN restate
extern "C" int fk_sweep_packed_smem() { return ps_smem_bytes(); }
extern "C" int fk_sweep_packed_group() { return FK_PS_QPW; }
extern "C" float fk_sweep_packed_box_margin() { return FK_PS_BOX_MARGIN; }

extern "C" int fk_sweep_packed(const float* f, const int* cids,
                               const int* desc, float* out, int n, int npad,
                               int sy, int sz, float h, float k1, float k2,
                               void* stream) {
    if (npad <= 0) return (int)cudaGetLastError();
    static FkOptIn opt_in;                // past 48 KB
    const cudaError_t err = opt_in(packed_sweep_kernel, ps_smem_bytes());
    if (err != cudaSuccess) return (int)err;
    packed_sweep_kernel<<<npad / FK_TQ, 32 * FK_PS_WARPS, ps_smem_bytes(),
                          (cudaStream_t)stream>>>(
        (const float4*)f, cids, desc, out, n, sy, sz / sy, h, k1, k2);
    return (int)cudaGetLastError();
}
