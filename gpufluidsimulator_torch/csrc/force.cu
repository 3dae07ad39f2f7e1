// Kernel 4: pressure gradient + viscosity Laplacian with the EOS fused,
// one CUDA template (force_kernel) in three modes that share one pair loop:
//   * plain (fk_force): acceleration out, gravity excluded.  Replaces
//     gpufluidsimulator_tpu/ops/pallas_sph.py:_force_kernel with
//     fuse_integrate = emit_movers = continuity = False.
//   * fused step (fk_force_step, kernel 4b): the same kernel with
//     fuse_integrate = emit_movers = True (pallas_sph.py:530-607) — see the
//     note above force_step_epilogue below.
//   * continuity step (fk_force_step_cont, kernel 4c): the fused step with
//     continuity = True — see the note above FkCont below.
//
// Pair loop (every mode).  Same arithmetic and constant folds as the TPU
// kernel (pallas_sph.py:264-271, 387-398, 419-488), for every valid rank of
// an interior cell:
//   rho_s  = valid ? max(rho, 1e-3 rho0) : rho0            (both sides)
//   pterm  = m_spiky * p(rho_s) / rho_s^2,  ir = m_visc_sqrt / rho_s
//   inv_r  = rsqrt(max(r^2, 1e-16)),  r = r^2 inv_r,  hr = max(h - r, 0)
//   coef_p = (pterm_q + pterm_c) hr^2 inv_r,  coef_v = hr (ir_q ir_c)
//   a     += coef_p d + coef_v v_c,  sv += coef_v;   a -= v_q sv at the end
// over the 3^d neighbour cells' valid ranks, in the order dz, dy, dx, rank
// (the self pair cancels: d = 0 and its viscosity term is removed by the
// -v_q sv finish).  Every other slot gets 0 in plain mode.  The fused
// steps define at every other slot only what a reader reads there (the
// TPU kernel leaves all of it undefined): x gets the sentinel and the
// flag 0 at every slot, since compact reads the flag whole and consolidate
// reads x (and the flag where x is valid) up to each interior cell's first
// sentinel rank; y, z, the velocities (and rho) get the sentinel or 0 only
// in the 32-byte sectors (8 lanes of a rank row) that hold a query, so no
// sector is written in part, and are left undefined in the others: compact
// reads them only at flagged slots and consolidate only at kept ones, both
// queries.  force_fill_skipped counts the sectors left (sph.FILL_SKIPPED).
//
// Bound on the H100: bytes.  Every slot of the 3 planes of plain mode is
// written once: 3 * K * cells * 4 B = 176 MB at the 1,197,770-particle
// double dam break.  The fused steps write 2 planes at every slot, 118 MB
// there, and the other 5 (6 with rho) in the sectors that hold a query,
// 14% of them on the evolved scene (force_fill_skipped reads 86.0%; 87.8%
// at 4,825,800 particles), 17 MB more at their empty slots: 0.04 ms at
// 3.35 TB/s, about the pair arithmetic (32 to 49 float32 operations for
// each of 6.9e7 candidate pairs, 0.03 to 0.05 ms at 67 TFLOP/s).
//
// The first design (one thread per cell, its valid query ranks in KMAX
// register slots, the 27 neighbour cells walked serially) ran 14 to 18x
// this bound (force_step 1.87198 ms, force_step_cont 2.80023 ms on the
// evolved double dam break, H100 80GB HBM3 at 700 W): most threads held no
// query, the pair body was issued for all KMAX slots, each candidate's EOS
// and 7 channel loads were redone by each of the 27 cells that read it, a
// warp ran as long as its fullest cell, and 160 registers (continuity)
// left 12 warps per SM.
//
// The second design (the row tile of csrc/tile.cuh: a block of 256 threads
// per 4 rows x 32 lanes of one plane, candidates staged per dz plane and
// query round) ran 5.2x this bound (force_step 0.69 to 0.70 ms, 0.80 for
// force_step_cont): its staging and pair loop took 0.444 ms of 0.705, since
// each neighbour plane was staged by the three blocks above, at and below
// it, 6 x 34 cells with every rank's 7 loads for 4 x 32 cells of queries,
// and again by a tile's second round of queries (17% of the tiles of the
// evolved scene hold more than 256).
//
// This design: the z-marching column of csrc/ring.cuh.  A block of 256
// threads marches FK_Z planes of one 4 x 32 tile; its ring holds the
// neighbour planes z-1, z, z+1, each compacted to its valid slots and
// staged once for every query of the column that reads it; a staged slot
// holds two float4, (x, y, z, pterm) and (vx, vy, vz, ir), with the EOS
// folded once.  The queries are laid out cell-major (the threads of one
// cell read the same candidates at once, a broadcast), one at a thread;
// each walks its 3 x 3 cells one range of slots a row, with 4
// accumulators (5 with the continuity sum) and its query's 8 values.  The
// constants are measured (H100 80GB HBM3 at 700 W, force_step on the
// evolved double dam break, against each other in one process): FK_Z = 2
// (1: +6%, 3: +1%, 4: +4%, 8: +11%; the fewer planes a column, the more
// columns share the card and the shorter its last wave), registers capped
// at 80 for 3 blocks an SM (capped at 64 for 4, they spill: +5%), FK_CAP =
// 576 slots a plane (640: +4%, a ring that leaves the loads less L1; at
// 576, 22 of the scene's planes a launch take windows), cell-major queries
// (rank-major: +4%) and a pair loop unrolled twice (not unrolled: +4%;
// four times: +3%).  The fused steps' fill takes 4 lanes a thread with
// float4 stores (tile.cuh fk_tile_fill4): a lane a thread with a ballot a
// run took force_step 1.637 to 1.647 ms on the evolved 4,825,800-particle
// scene against 1.590 (0.434 against 0.429 at 1,197,770); skipping every
// empty lane, so that sectors are written in part, took 1.609 (0.427).
#include "ring.cuh"

#define FK_MAX_OBS 4
#define FK_Z 2                  // z planes a block marches
#define FK_CAP 576              // slots a ring plane holds: 2.8 a cell
#define FK_MIN_BLOCKS 3         // blocks an SM: caps registers at 80

struct FkEos {
    float rho0, rho_floor;     // rest density, 1e-3 * rest density
    float stiffness;           // linear: p = k (rho - rho0)
    int tait;                  // 1: p = b ((rho/rho0)^gamma - 1)
    float tait_b, tait_gamma;
    int clamp;                 // clamp negative pressure to 0
    float m_spiky, m_visc_sqrt;
};

// pterm = m_spiky * p / rho^2 and ir = m_visc_sqrt / rho of one valid slot
// from its raw density (the TPU kernel's window-build EOS fold; invalid
// slots, which it sanitises to rho0, are never read here)
__device__ __forceinline__ void fk_eos_terms(float rho_raw, const FkEos& e,
                                             float* pterm, float* ir) {
    const float rho = fmaxf(rho_raw, e.rho_floor);
    float p;
    if (e.tait)
        p = e.tait_b * (powf(rho / e.rho0, e.tait_gamma) - 1.0f);
    else
        p = e.stiffness * (rho - e.rho0);
    if (e.clamp) p = fmaxf(p, 0.0f);
    *pterm = e.m_spiky * p / (rho * rho);
    *ir = e.m_visc_sqrt / rho;
}

// Constants of the fused step's epilogue (sph._step_args packs them).
struct FkStep {
    float dt, damp, one_plus_rest;      // -restitution, 1 + restitution
    float grav[3], lo[3], hi[3], inv_cell[3];
    float slab0, slab1;                 // [binning x origin, slab end)
    int n_obs;
    int obs_kind[FK_MAX_OBS];           // 0 box, 1 sphere
    float obs_c[FK_MAX_OBS][3];
    float obs_e[FK_MAX_OBS][3];         // box half extents; sphere radius
};

// Kernel 4c, the continuity tier (pallas_sph.py:238-372, 407-487, 514-518,
// 588-606).  The density input is the CARRIED rho plane; the pair loop adds,
// with dot = (v_q - v_c).d, d2 = max(h^2 - r^2, 0), d4 = d2^2:
//   psum -= clip(c_corr d4 dot, +-corr_cap)                (use_corr)
//   psum -= c_av min(dot / (r^2 + 0.01 h^2), 0)            (use_alpha)
//   sr   += d4 dot (rate) | d4 (dot + kappa_d2 d2) (relax) | d4 d2 (sum)
//         | d4 ((dot - kappa) + kappa rho_q / m_visc_sqrt * ir_c) (delta)
// and the epilogue writes rho_new = rho_q + drho_scale sr (rate, delta),
// one_m_l (rho_q + drho_scale sr) (relax) or rho_sum_scale sr (sum), from
// the query's RAW carried rho_q (the EOS alone reads max(rho, 1e-3 rho0)),
// and 0 on the other slots of the sectors that hold a query (rho, like y,
// is left undefined in the others: the note at the top).  The self pair
// stays in the loop: it adds h^6 to sum and relax, and cancels in delta
// only above the EOS floor.
//
// Bound on the H100: bytes, as kernel 4b, plus one more output plane
// written where y is (4 B a slot of the sectors that hold a query); the
// default form (rate, cont_beta > 0) adds 17 operations to the pair's 32.
// Design: the form is a template parameter, so the default pays neither
// for delta's per-query factor nor for the other forms' branches; rho_q is
// reread from the carried plane in the epilogue instead of held live
// through the pair loop, as the TPU kernel rereads its centre input.
#define FK_CONT_NONE 0
#define FK_CONT_RATE 1
#define FK_CONT_RELAX 2
#define FK_CONT_SUM 3
#define FK_CONT_DELTA 4

struct FkCont {
    float h2, drho_scale, rho_sum_scale, kappa_d2, one_m_l;
    float c_corr, corr_cap, c_av, eps_h2, kappa, kappa_over_mv;
    int use_corr, use_alpha;
};

__device__ __forceinline__ float fk_sign(float x) {
    return (float)((x > 0.0f) - (x < 0.0f));
}

// Walls, then each obstacle in order: ops/physics.py:collide_axes, the same
// operations in the same order (box normals on the first axis attaining
// the max; sqrt with the 1e-20 eps).
template <int DIM>
__device__ __forceinline__ void fk_collide(float* p, float* v,
                                           const FkStep& s) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
        if (p[d] < s.lo[d] || p[d] > s.hi[d]) v[d] = v[d] * s.damp;
        p[d] = fminf(fmaxf(p[d], s.lo[d]), s.hi[d]);
    }
    for (int o = 0; o < s.n_obs; ++o) {
        float n[3] = {0.0f, 0.0f, 0.0f};
        float sdf;
        if (s.obs_kind[o] == 1) {
            float dv[3];
            float ss = 0.0f;
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
                dv[d] = p[d] - s.obs_c[o][d];
                ss = ss + dv[d] * dv[d];
            }
            const float r = sqrtf(ss + 1e-20f);
            sdf = r - s.obs_e[o][0];
#pragma unroll
            for (int d = 0; d < DIM; ++d) n[d] = dv[d] / r;
        } else {
            float q[3], out[3], sgn[3];
            float qmax = 0.0f, so = 0.0f;
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
                q[d] = fabsf(p[d] - s.obs_c[o][d]) - s.obs_e[o][d];
                qmax = d == 0 ? q[0] : fmaxf(qmax, q[d]);
                out[d] = fmaxf(q[d], 0.0f);
                so = so + out[d] * out[d];
                sgn[d] = fk_sign(p[d] - s.obs_c[o][d]);
            }
            so = sqrtf(so + 1e-20f);
            if (qmax > 0.0f) {
                sdf = so;
#pragma unroll
                for (int d = 0; d < DIM; ++d)
                    n[d] = out[d] * sgn[d] / (so + 1e-20f);
            } else {
                sdf = fminf(qmax, 0.0f);
                bool taken = false;
#pragma unroll
                for (int d = 0; d < DIM; ++d) {
                    const bool first = !taken && q[d] == qmax;
                    taken = taken || first;
                    n[d] = first ? sgn[d] : 0.0f;
                }
            }
        }
        const bool inside = sdf < 0.0f;
        float vn = 0.0f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
            if (inside) p[d] = p[d] - sdf * n[d];
            vn = vn + v[d] * n[d];
        }
        if (inside && vn < 0.0f) {
            const float dvn = s.one_plus_rest * vn;
#pragma unroll
            for (int d = 0; d < DIM; ++d) v[d] = v[d] - dvn * n[d];
        }
    }
}

__device__ __forceinline__ int fk_cell_of(float x, float base, float inv,
                                          int n) {
    const int c = (int)floorf((x - base) * inv);
    return min(max(c, 0), n - 1);
}

// Kernel 4b epilogue, for one valid query rank of an interior cell:
//   v' = v + (a + g) dt,  x' = x + v' dt,  then walls and obstacles;
//   moved = the float32 cell floor((x' - lo) * (1/cell)) differs from the
//           slot's own cell on any axis, or x' left the x slab
// (pallas_sph.py:530-587).  The planes come out UNBLANKED: a mover keeps
// its slot, flagged, so the compaction reads it straight out of new6.
//
// Bound on the H100 (fused mode): the x and flag planes written at every
// slot, the other 5 in the sectors that hold a query (the note at the
// top), plus the 7 inputs read at the valid slots only — bytes, about the
// pair arithmetic's time.  Design: the epilogue runs in the registers of
// the thread that holds the query, so the acceleration never touches
// memory; it writes every plane at its query's slot, which with the fill
// defines every slot of a sector that holds a query.
template <int DIM>
__device__ __forceinline__ void force_step_epilogue(
        float qx, float qy, float qz, float qvx, float qvy, float qvz,
        float ax, float ay, float az, const FkStep& st, const FkCell& cc,
        const FkGeom& g, float* out6, float* flag, long long s,
        long long ch) {
    float a[3] = {ax, ay, az};
    float v[3] = {qvx, qvy, qvz};
    float p[3] = {qx, qy, qz};
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
        v[d] = v[d] + (a[d] + st.grav[d]) * st.dt;
        p[d] = p[d] + v[d] * st.dt;
    }
    fk_collide<DIM>(p, v, st);
    const int gx = cc.xo * FK_TILE_X + cc.lane - 1;
    bool moved = fk_cell_of(p[0], st.slab0, st.inv_cell[0], g.nx) != gx;
    moved |= fk_cell_of(p[1], st.lo[1], st.inv_cell[1], g.ny)
                 + FK_ROWS_PER_BLOCK != cc.y;
    if (DIM == 3)
        moved |= fk_cell_of(p[2], st.lo[2], st.inv_cell[2], g.nz) + 1
                     != cc.z;
    moved |= p[0] < st.slab0 || p[0] >= st.slab1;
    out6[s] = p[0];
    out6[ch + s] = p[1];
    out6[2 * ch + s] = DIM == 3 ? p[2] : 0.0f;
    out6[3 * ch + s] = v[0];
    out6[4 * ch + s] = v[1];
    out6[5 * ch + s] = DIM == 3 ? v[2] : 0.0f;
    flag[s] = moved ? 1.0f : 0.0f;
}

// Every output slot of a slot that holds no query: 0, or on the fused
// step the sentinel position, velocity 0, flag 0 (and rho 0).
template <bool FUSE, int CONT>
__device__ __forceinline__ void fk_fill(float* out, float* flag,
                                        float* rho_out, long long s,
                                        long long ch) {
    if constexpr (FUSE) {
        out[s] = FK_SENTINEL;
        out[ch + s] = FK_SENTINEL;
        out[2 * ch + s] = FK_SENTINEL;
        out[3 * ch + s] = 0.0f;
        out[4 * ch + s] = 0.0f;
        out[5 * ch + s] = 0.0f;
        flag[s] = 0.0f;
        if constexpr (CONT != FK_CONT_NONE) rho_out[s] = 0.0f;
    } else {
        out[s] = 0.0f;
        out[ch + s] = 0.0f;
        out[2 * ch + s] = 0.0f;
    }
}

// The fused step's 4 slots s0 .. s0 + 3 that hold no query, float4 stores
// (the planes are 16-byte aligned, s0 a multiple of 4): the sentinel x and
// flag 0, and where their sector holds a query (held) the sentinel y, z,
// velocity 0 (and rho 0); elsewhere those planes are left (the note at the
// top).
template <int CONT>
__device__ __forceinline__ void fk_fill4(float* out, float* flag,
                                         float* rho_out, long long s0,
                                         long long ch, bool held) {
    const float4 sent = make_float4(FK_SENTINEL, FK_SENTINEL, FK_SENTINEL,
                                    FK_SENTINEL);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const auto at = [&](float* p, long long o) {
        return reinterpret_cast<float4*>(p + o + s0);
    };
    *at(out, 0) = sent;
    *at(flag, 0) = zero;
    if (!held) return;
    *at(out, ch) = sent;
    *at(out, 2 * ch) = sent;
    *at(out, 3 * ch) = zero;
    *at(out, 4 * ch) = zero;
    *at(out, 5 * ch) = zero;
    if constexpr (CONT != FK_CONT_NONE) *at(rho_out, 0) = zero;
}

// One block per column of FK_Z planes of a tile of FK_TILE_ROWS rows x 32
// lanes (see the note at the top and csrc/ring.cuh).  Dynamic shared
// memory: 2 * FK_CAP float4 a ring plane, the staged (x, y, z, pterm) and
// (vx, vy, vz, ir) of its compacted slots; FR_RING planes in 3D, one in
// 2D.  ring_ovf: the count of ring planes that overflowed.  fill_ctr (the
// fused modes): += the sectors the fill left unwritten, the sectors it
// visited (two 64-bit counts; one atomic each a block).
template <int KMAX, int DIM, bool FUSE, int CONT>
__global__ void __launch_bounds__(FK_THREADS, FK_MIN_BLOCKS)
force_kernel(const float* __restrict__ fields, const float* __restrict__ rho,
             FkOcc occ, float* __restrict__ acc_out,
             float* __restrict__ flag_out, float* __restrict__ rho_out,
             int* __restrict__ ring_ovf,
             unsigned long long* __restrict__ fill_ctr, FkGeom g, float h,
             FkEos e, FkStep st, FkCont ct) {
    constexpr int CAP = FK_CAP;
    extern __shared__ float4 fk_stage[];
    float4* s_a = fk_stage;
    float4* s_b = fk_stage + (DIM == 3 ? FR_RING : 1) * CAP;
    __shared__ FrRing ring;
    __shared__ FkQueries<KMAX> sq;
    __shared__ int fill_skipped;   // the block's sectors left (fused modes)

    const long long cells = g.cells;
    const long long ch = (long long)g.k * cells;   // channel stride
    const float* X = fields;
    const float* Y = fields + ch;
    const float* Z = fields + 2 * ch;
    const float* VX = fields + 3 * ch;
    const float* VY = fields + 4 * ch;
    const float* VZ = fields + 5 * ch;

    // a staged slot (valid) into ring index i: its 7 loads in flight at
    // once, the EOS folded
    const auto stage = [&](int i, long long s) {
        const float x = X[s];
        const float yv = Y[s], zv = DIM == 3 ? Z[s] : 0.0f;
        const float vxv = VX[s], vyv = VY[s];
        const float vzv = DIM == 3 ? VZ[s] : 0.0f;
        float cp, cir;
        fk_eos_terms(rho[s], e, &cp, &cir);
        s_a[i] = make_float4(x, yv, zv, cp);
        s_b[i] = make_float4(vxv, vyv, vzv, cir);
    };

    const FrColumn col = fr_column<FK_Z>(g);
    if (FUSE && threadIdx.x == 0) fill_skipped = 0;
    // the ring holds the planes lo .. hi (none while hi < lo), plane p in
    // ring slot p % FR_RING (block-uniform)
    int lo = 0, hi = -1;
    for (int z = col.z0; z < col.z1; ++z) {
        __syncthreads();          // the last plane's readers are done
        const FkTile t = fr_tile<DIM>(g, occ, col, z);
        const int nq = fk_tile_queries<KMAX, DIM>(X, g, t, occ, sq);
        const auto fill = [&](long long s) {
            fk_fill<FUSE, CONT>(acc_out, flag_out, rho_out, s, ch);
        };
        if constexpr (FUSE) {
            const int skipped = fk_tile_fill4<KMAX>(
                g, t, sq, [&](long long s0, bool held) {
                    fk_fill4<CONT>(acc_out, flag_out, rho_out, s0, ch, held);
                }, fill);
            if ((threadIdx.x & 31) == 0 && skipped != 0)
                atomicAdd(&fill_skipped, skipped);
        } else {
            fk_tile_fill<KMAX>(g, t, sq, fill);
        }
        if (nq == 0) continue;
        // stage the neighbour planes the ring lacks, lowest first
        for (int dz = (DIM == 3 ? -1 : 0); dz <= (DIM == 3 ? 1 : 0); ++dz) {
            const int p = z + dz;
            if (p >= lo && p <= hi) continue;
            if (p != hi + 1) lo = p;
            hi = p;
            lo = max(lo, hi - (FR_RING - 1));
            const int slot = DIM == 3 ? p % FR_RING : 0;
            int* off = ring.off[slot];
            fr_count<KMAX>(X, g, t, dz, sq.kz[dz + 1], off, ring.wsum);
            const int total = off[FK_STAGE_CELLS];
            if (total <= CAP) {
                fr_stage(t, g, dz, off, 0, total, [&](int i, long long sl) {
                    stage(slot * CAP + i, sl);
                });
            } else if (threadIdx.x == 0) {
                atomicAdd(ring_ovf, 1);
            }
        }
        __syncthreads();

        for (int q0 = 0; q0 < nq; q0 += FK_THREADS) {
            const int j = q0 + (int)threadIdx.x;
            const bool active = j < nq;
            FkQuery q{0, 0, 0};
            float qx = 0.0f, qy = 0.0f, qz = 0.0f;
            float qvx = 0.0f, qvy = 0.0f, qvz = 0.0f;
            float qp = 0.0f, qir = 0.0f, qdel = 0.0f;
            if (active) {
                q = fk_tile_query<KMAX>(sq, j, t, cells);
                const long long s = q.s;
                qx = X[s];
                qy = Y[s];
                qvx = VX[s];
                qvy = VY[s];
                if (DIM == 3) {
                    qz = Z[s];
                    qvz = VZ[s];
                }
                const float rq = rho[s];
                fk_eos_terms(rq, e, &qp, &qir);
                if (CONT == FK_CONT_DELTA) qdel = rq * ct.kappa_over_mv;
            }
            float ax = 0.0f, ay = 0.0f, az = 0.0f, sv = 0.0f, sr = 0.0f;
            const auto pair = [&](int c) {
                const float4 ca = s_a[c];
                const float4 cb = s_b[c];
                const float ddx = qx - ca.x;
                const float ddy = qy - ca.y;
                float r2 = ddx * ddx + ddy * ddy;
                float ddz = 0.0f;
                if (DIM == 3) {
                    ddz = qz - ca.z;
                    r2 = r2 + ddz * ddz;
                }
                const float inv_r = rsqrtf(fmaxf(r2, 1e-16f));
                const float r = r2 * inv_r;
                const float hr = fmaxf(h - r, 0.0f);
                float psum = qp + ca.w;
                if constexpr (CONT != FK_CONT_NONE) {
                    float dot = (qvx - cb.x) * ddx + (qvy - cb.y) * ddy;
                    if (DIM == 3) dot = dot + (qvz - cb.z) * ddz;
                    const float d2 = fmaxf(ct.h2 - r2, 0.0f);
                    const float d4 = d2 * d2;
                    const float t_dot = d4 * dot;
                    if (ct.use_corr)
                        psum = psum - fminf(fmaxf(ct.c_corr * t_dot,
                                                  -ct.corr_cap), ct.corr_cap);
                    if (ct.use_alpha) {
                        const float rr = rsqrtf(r2 + ct.eps_h2);
                        psum = psum - ct.c_av * fminf(dot * (rr * rr), 0.0f);
                    }
                    if constexpr (CONT == FK_CONT_SUM)
                        sr += d4 * d2;
                    else if constexpr (CONT == FK_CONT_RELAX)
                        sr += d4 * (dot + ct.kappa_d2 * d2);
                    else if constexpr (CONT == FK_CONT_DELTA)
                        sr += d4 * ((dot - ct.kappa) + qdel * cb.w);
                    else
                        sr += t_dot;
                }
                const float coef_p = psum * (hr * hr * inv_r);
                const float coef_v = hr * (qir * cb.w);
                sv += coef_v;
                ax += coef_p * ddx + coef_v * cb.x;
                ay += coef_p * ddy + coef_v * cb.y;
                if (DIM == 3) az += coef_p * ddz + coef_v * cb.z;
            };
            for (int dz = (DIM == 3 ? -1 : 0); dz <= (DIM == 3 ? 1 : 0);
                 ++dz) {
                const int slot = DIM == 3 ? (z + dz) % FR_RING : 0;
                const int* off = ring.off[slot];
                const int total = off[FK_STAGE_CELLS];
                const int base = slot * CAP;
                const auto pair_at = [&](int c) { pair(base + c); };
                if (total <= CAP) {
                    if (active) fr_pairs(off, q.qr, q.l, 0, CAP, pair_at);
                    continue;
                }
                // an overflowed plane: a window of CAP slots at a time
                for (int w0 = 0; w0 < total; w0 += CAP) {
                    __syncthreads();      // the last window's readers are done
                    fr_stage(t, g, dz, off, w0, min(w0 + CAP, total),
                             [&](int i, long long sl) {
                                 stage(base + i, sl);
                             });
                    __syncthreads();
                    if (active)
                        fr_pairs(off, q.qr, q.l, w0, w0 + CAP, pair_at);
                }
            }
            if (!active) continue;
            const long long s = q.s;
            ax = ax - qvx * sv;
            ay = ay - qvy * sv;
            az = DIM == 3 ? az - qvz * sv : 0.0f;
            if constexpr (FUSE) {
                const FkCell cc{t.lane0 + q.l, t.y0 + q.qr, t.xo, t.z};
                force_step_epilogue<DIM>(qx, qy, qz, qvx, qvy, qvz, ax, ay,
                                         az, st, cc, g, acc_out, flag_out, s,
                                         ch);
                if constexpr (CONT == FK_CONT_SUM) {
                    rho_out[s] = ct.rho_sum_scale * sr;
                } else if constexpr (CONT != FK_CONT_NONE) {
                    const float rho_q = rho[s];     // raw, reread
                    float rn = rho_q + ct.drho_scale * sr;
                    if (CONT == FK_CONT_RELAX) rn = ct.one_m_l * rn;
                    rho_out[s] = rn;
                }
            } else {
                acc_out[s] = ax;
                acc_out[ch + s] = ay;
                acc_out[2 * ch + s] = az;
            }
        }
    }
    if constexpr (FUSE) {
        __syncthreads();
        if (threadIdx.x == 0) {
            atomicAdd(fill_ctr, (unsigned long long)fill_skipped);
            atomicAdd(fill_ctr + 1, (unsigned long long)(col.z1 - col.z0)
                          * FK_TILE_ROWS * g.k * (FK_TILE_LANES / 8));
        }
    }
}

// Dynamic shared memory of one block: two float4 per slot of each ring
// plane
template <int DIM>
constexpr int fk_stage_bytes() {
    return 2 * (DIM == 3 ? FR_RING : 1) * FK_CAP * (int)sizeof(float4);
}

template <int KMAX, int DIM, bool FUSE, int CONT>
static int launch_force(const float* fields, const float* rho,
                        const FkOcc& occ, float* out, float* flag,
                        float* rho_out, int* ring_ovf,
                        unsigned long long* fill_ctr, const FkGeom& g,
                        float h, const FkEos& e, const FkStep& s,
                        const FkCont& ct, cudaStream_t st) {
    constexpr int bytes = fk_stage_bytes<DIM>();
    // past 48 KB with the static part: once per instantiation and device
    static FkOptIn opt_in;
    const cudaError_t err = opt_in(force_kernel<KMAX, DIM, FUSE, CONT>,
                                   bytes);
    if (err != cudaSuccess) return (int)err;
    force_kernel<KMAX, DIM, FUSE, CONT>
        <<<(unsigned)fr_blocks<FK_Z>(g), FK_THREADS, bytes, st>>>(
            fields, rho, occ, out, flag, rho_out, ring_ovf, fill_ctr, g, h,
            e, s, ct);
    return (int)cudaGetLastError();
}

// One block per column of FK_Z planes of a tile of FK_TILE_ROWS rows x 32
// lanes: the rows of a (z, x tile) plane (py of them, a multiple of 8) lie
// in whole tiles
template <bool FUSE, int CONT>
static int force_entry(const float* fields, const float* rho,
                       const FkOcc& occ, float* out, float* flag,
                       float* rho_out, int* ring_ovf,
                       unsigned long long* fill_ctr, const FkGeom& g,
                       float h, const FkEos& e, const FkStep& s,
                       const FkCont& ct, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (g.cells % FK_LANES != 0 || g.py % FK_TILE_ROWS != 0
        || (g.dim != 2 && g.dim != 3) || g.k < 1 || g.k > 16)
        return (int)cudaErrorInvalidValue;
    if (g.k <= 8)
        return g.dim == 3
            ? launch_force<8, 3, FUSE, CONT>(fields, rho, occ, out, flag,
                                             rho_out, ring_ovf, fill_ctr, g,
                                             h, e, s, ct, st)
            : launch_force<8, 2, FUSE, CONT>(fields, rho, occ, out, flag,
                                             rho_out, ring_ovf, fill_ctr, g,
                                             h, e, s, ct, st);
    return g.dim == 3
        ? launch_force<16, 3, FUSE, CONT>(fields, rho, occ, out, flag,
                                          rho_out, ring_ovf, fill_ctr, g, h,
                                          e, s, ct, st)
        : launch_force<16, 2, FUSE, CONT>(fields, rho, occ, out, flag,
                                          rho_out, ring_ovf, fill_ctr, g, h,
                                          e, s, ct, st);
}

// occ_q, occ_s: sph.accel_planes' bounds (int32, any strides); ostr: their
// 7 strides in elements, a host array
extern "C" int fk_force(const float* fields, const float* rho,
                        const int* occ_q, const int* occ_s,
                        const long long* ostr, float* out, int* ring_ovf,
                        int dim, int k,
                        int nx, int ny, int nz, int n_bx, int py, int pz,
                        long long cells, float h, float rho0,
                        float rho_floor, float stiffness, int tait,
                        float tait_b, float tait_gamma, float m_spiky,
                        float m_visc_sqrt, int clamp, void* stream) {
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    const FkEos e{rho0, rho_floor, stiffness, tait, tait_b, tait_gamma,
                  clamp, m_spiky, m_visc_sqrt};
    return force_entry<false, FK_CONT_NONE>(
        fields, rho, fk_occ_from(occ_q, occ_s, ostr), out, nullptr, nullptr,
        ring_ovf, nullptr, g, h, e, FkStep{}, FkCont{}, stream);
}

// FkStep from the host float array of sph._step_args: dt, -restitution,
// 1 + restitution, gravity[3], lo[3], hi[3], 1/cell[3], slab[2], then 7
// floats per obstacle (kind, centre[3], half extents[3] or radius).
static FkStep fk_step_from(const float* step, int n_obs) {
    FkStep s{};
    s.dt = step[0];
    s.damp = step[1];
    s.one_plus_rest = step[2];
    for (int d = 0; d < 3; ++d) {
        s.grav[d] = step[3 + d];
        s.lo[d] = step[6 + d];
        s.hi[d] = step[9 + d];
        s.inv_cell[d] = step[12 + d];
    }
    s.slab0 = step[15];
    s.slab1 = step[16];
    s.n_obs = n_obs;
    for (int o = 0; o < n_obs; ++o) {
        const float* ob = step + 17 + 7 * o;
        s.obs_kind[o] = (int)ob[0];
        for (int d = 0; d < 3; ++d) {
            s.obs_c[o][d] = ob[1 + d];
            s.obs_e[o][d] = ob[4 + d];
        }
    }
    return s;
}

// fill_ctr: two int64 counts the fill adds to (force_kernel)
extern "C" int fk_force_step(const float* fields, const float* rho,
                             const int* occ_q, const int* occ_s,
                             const long long* ostr, float* new6, float* flag,
                             int* ring_ovf, long long* fill_ctr, int dim,
                             int k, int nx, int ny, int nz,
                             int n_bx, int py, int pz, long long cells,
                             float h, float rho0, float rho_floor,
                             float stiffness, int tait, float tait_b,
                             float tait_gamma, float m_spiky,
                             float m_visc_sqrt, int clamp, const float* step,
                             int n_obs, void* stream) {
    if (n_obs < 0 || n_obs > FK_MAX_OBS) return (int)cudaErrorInvalidValue;
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    const FkEos e{rho0, rho_floor, stiffness, tait, tait_b, tait_gamma,
                  clamp, m_spiky, m_visc_sqrt};
    return force_entry<true, FK_CONT_NONE>(
        fields, rho, fk_occ_from(occ_q, occ_s, ostr), new6, flag, nullptr,
        ring_ovf, (unsigned long long*)fill_ctr, g, h, e,
        fk_step_from(step, n_obs), FkCont{}, stream);
}

// rho: the CARRIED density (halo lanes refreshed); rho_out: next step's.
// form: FK_CONT_RATE..FK_CONT_DELTA (sph.CONT_FORMS); cont: the host float
// array of sph._cont_args, the float fields of FkCont in order.
extern "C" int fk_force_step_cont(const float* fields, const float* rho,
                                  const int* occ_q, const int* occ_s,
                                  const long long* ostr, float* new6,
                                  float* rho_out, float* flag,
                                  int* ring_ovf, long long* fill_ctr,
                                  int dim, int k, int nx,
                                  int ny, int nz, int n_bx, int py, int pz,
                                  long long cells, float h,
                                  float rho0, float rho_floor,
                                  float stiffness, int tait, float tait_b,
                                  float tait_gamma, float m_spiky,
                                  float m_visc_sqrt, int clamp,
                                  const float* step, int n_obs, int form,
                                  int use_corr, int use_alpha,
                                  const float* cont, void* stream) {
    if (n_obs < 0 || n_obs > FK_MAX_OBS) return (int)cudaErrorInvalidValue;
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    const FkEos e{rho0, rho_floor, stiffness, tait, tait_b, tait_gamma,
                  clamp, m_spiky, m_visc_sqrt};
    const FkStep s = fk_step_from(step, n_obs);
    const FkCont ct{cont[0], cont[1], cont[2], cont[3], cont[4], cont[5],
                    cont[6], cont[7], cont[8], cont[9], cont[10],
                    use_corr, use_alpha};
    const FkOcc occ = fk_occ_from(occ_q, occ_s, ostr);
    unsigned long long* fc = (unsigned long long*)fill_ctr;
    switch (form) {
        case FK_CONT_RATE:
            return force_entry<true, FK_CONT_RATE>(
                fields, rho, occ, new6, flag, rho_out, ring_ovf, fc, g, h, e,
                s, ct, stream);
        case FK_CONT_RELAX:
            return force_entry<true, FK_CONT_RELAX>(
                fields, rho, occ, new6, flag, rho_out, ring_ovf, fc, g, h, e,
                s, ct, stream);
        case FK_CONT_SUM:
            return force_entry<true, FK_CONT_SUM>(
                fields, rho, occ, new6, flag, rho_out, ring_ovf, fc, g, h, e,
                s, ct, stream);
        case FK_CONT_DELTA:
            return force_entry<true, FK_CONT_DELTA>(
                fields, rho, occ, new6, flag, rho_out, ring_ovf, fc, g, h, e,
                s, ct, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
