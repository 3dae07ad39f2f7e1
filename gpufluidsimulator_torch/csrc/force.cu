// Kernel 4: pressure gradient + viscosity Laplacian with the EOS fused, in
// two modes that share one pair loop:
//   * plain (fk_force): acceleration out, gravity excluded.  Replaces
//     gpufluidsimulator_tpu/ops/pallas_sph.py:_force_kernel with
//     fuse_integrate = emit_movers = continuity = False.
//   * fused step (fk_force_step, kernel 4b): the same kernel with
//     fuse_integrate = emit_movers = True (pallas_sph.py:530-607) — see the
//     note above force_step_epilogue below.
//   * continuity step (fk_force_step_cont, kernel 4c): the fused step with
//     continuity = True — see the note above FkCont below.
//
// Pair loop (both modes).  Same arithmetic and
// constant folds as the TPU kernel (pallas_sph.py:264-271, 387-398,
// 419-488), for every valid rank of an interior cell:
//   rho_s  = valid ? max(rho, 1e-3 rho0) : rho0            (both sides)
//   pterm  = m_spiky * p(rho_s) / rho_s^2,  ir = m_visc_sqrt / rho_s
//   inv_r  = rsqrt(max(r^2, 1e-16)),  r = r^2 inv_r,  hr = max(h - r, 0)
//   coef_p = (pterm_q + pterm_c) hr^2 inv_r,  coef_v = hr (ir_q ir_c)
//   a     += coef_p d + coef_v v_c,  sv += coef_v;   a -= v_q sv at the end
// over the 3^d neighbour cells' valid ranks (the self pair cancels: d = 0
// and its viscosity term is removed by the -v_q sv finish).  Every other
// slot gets 0 (the TPU kernel leaves it undefined).
//
// Bound on the H100: writing the 3 acceleration planes (3 * K * cells * 4 B,
// 116 MB at the 260,850-particle 3D dam break) plus reading the inputs at
// the valid slots (x up to each cell's first sentinel rank) outweighs the
// pair arithmetic (~32 flops for each of ~1.5e7 pairs) — bytes.  Design as in
// density.cu: one thread per cell, its valid query ranks in registers,
// each candidate (with its EOS terms) loaded and computed once and paired
// with all of them; a warp reads 32 neighbouring lanes of one row.
#include "common.cuh"

#define FK_MAX_OBS 4

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
// and 0 on every other slot.  The self pair stays in the loop: it adds h^6
// to sum and relax, and cancels in delta only above the EOS floor.
//
// Bound on the H100: bytes, as kernel 4b, plus one more output plane (8 *
// K * cells * 4 B = 470 MB at the 1,197,770-particle double dam break); the
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
// Bound on the H100 (fused mode): the 7 output planes (6 + flag) written
// once, 7 * K * cells * 4 B = 411 MB at the 1,197,770-particle double dam
// break, plus the 7 inputs read at the valid slots only (0.135 ms in all) —
// bytes, well above the pair arithmetic.  Design: the epilogue runs in the
// registers that already hold the query ranks, so the acceleration never
// touches memory; every slot is written, so nothing is left undefined.
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

template <int KMAX, int DIM, bool FUSE, int CONT>
__global__ void __launch_bounds__(128)
force_kernel(const float* __restrict__ fields, const float* __restrict__ rho,
             float* __restrict__ acc_out, float* __restrict__ flag_out,
             float* __restrict__ rho_out, FkGeom g, float h, FkEos e,
             FkStep st, FkCont ct) {
    const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (c >= g.cells) return;
    const long long cells = g.cells;
    const int k = g.k;
    const long long ch = (long long)k * cells;     // channel stride
    const float* X = fields;
    const float* Y = fields + ch;
    const float* Z = fields + 2 * ch;
    const float* VX = fields + 3 * ch;
    const float* VY = fields + 4 * ch;
    const float* VZ = fields + 5 * ch;

    float qx[KMAX], qy[KMAX], qz[KMAX], qvx[KMAX], qvy[KMAX], qvz[KMAX];
    float qp[KMAX], qir[KMAX];
    float ax[KMAX], ay[KMAX], az[KMAX], sv[KMAX];
    float sr[KMAX], qdel[KMAX];        // continuity only (else dead)
    int nq = 0;
    const bool interior = fk_interior(c, g);
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
        ax[q] = ay[q] = az[q] = sv[q] = sr[q] = qdel[q] = 0.0f;
        qx[q] = qy[q] = qz[q] = qvx[q] = qvy[q] = qvz[q] = 0.0f;
        qp[q] = qir[q] = 0.0f;
        if (interior && q < k && q == nq) {
            const long long s = (long long)q * cells + c;
            const float xv = X[s];
            if (xv < FK_HALF_SENTINEL) {
                qx[q] = xv;
                qy[q] = Y[s];
                qvx[q] = VX[s];
                qvy[q] = VY[s];
                if (DIM == 3) {
                    qz[q] = Z[s];
                    qvz[q] = VZ[s];
                }
                const float rq = rho[s];
                fk_eos_terms(rq, e, &qp[q], &qir[q]);
                if (CONT == FK_CONT_DELTA) qdel[q] = rq * ct.kappa_over_mv;
                nq = q + 1;
            }
        }
    }

    if (nq > 0) {
        const long long zs = (long long)g.n_bx * g.py * FK_LANES;
        for (int dz = (DIM == 3 ? -1 : 0); dz <= (DIM == 3 ? 1 : 0); ++dz) {
            for (int dy = -1; dy <= 1; ++dy) {
                for (int dx = -1; dx <= 1; ++dx) {
                    const long long nc = c + dz * zs + dy * FK_LANES + dx;
                    for (int k2 = 0; k2 < k; ++k2) {
                        const long long s = (long long)k2 * cells + nc;
                        const float cx = X[s];
                        if (!(cx < FK_HALF_SENTINEL)) break;
                        const float cy = Y[s];
                        const float cz = DIM == 3 ? Z[s] : 0.0f;
                        const float cvx = VX[s];
                        const float cvy = VY[s];
                        const float cvz = DIM == 3 ? VZ[s] : 0.0f;
                        float cp, cir;
                        fk_eos_terms(rho[s], e, &cp, &cir);
#pragma unroll
                        for (int q = 0; q < KMAX; ++q) {
                            if (q < nq) {
                                const float ddx = qx[q] - cx;
                                const float ddy = qy[q] - cy;
                                float r2 = ddx * ddx + ddy * ddy;
                                float ddz = 0.0f;
                                if (DIM == 3) {
                                    ddz = qz[q] - cz;
                                    r2 = r2 + ddz * ddz;
                                }
                                const float inv_r = rsqrtf(fmaxf(r2, 1e-16f));
                                const float r = r2 * inv_r;
                                const float hr = fmaxf(h - r, 0.0f);
                                float psum = qp[q] + cp;
                                if constexpr (CONT != FK_CONT_NONE) {
                                    float dot = (qvx[q] - cvx) * ddx
                                                + (qvy[q] - cvy) * ddy;
                                    if (DIM == 3)
                                        dot = dot + (qvz[q] - cvz) * ddz;
                                    const float d2 = fmaxf(ct.h2 - r2, 0.0f);
                                    const float d4 = d2 * d2;
                                    const float t_dot = d4 * dot;
                                    if (ct.use_corr)
                                        psum = psum - fminf(fmaxf(
                                            ct.c_corr * t_dot, -ct.corr_cap),
                                            ct.corr_cap);
                                    if (ct.use_alpha) {
                                        const float rr =
                                            rsqrtf(r2 + ct.eps_h2);
                                        psum = psum - ct.c_av * fminf(
                                            dot * (rr * rr), 0.0f);
                                    }
                                    if constexpr (CONT == FK_CONT_SUM)
                                        sr[q] += d4 * d2;
                                    else if constexpr (CONT == FK_CONT_RELAX)
                                        sr[q] += d4 * (dot + ct.kappa_d2 * d2);
                                    else if constexpr (CONT == FK_CONT_DELTA)
                                        sr[q] += d4 * ((dot - ct.kappa)
                                                       + qdel[q] * cir);
                                    else
                                        sr[q] += t_dot;
                                }
                                const float coef_p =
                                    psum * (hr * hr * inv_r);
                                const float coef_v = hr * (qir[q] * cir);
                                sv[q] += coef_v;
                                ax[q] += coef_p * ddx + coef_v * cvx;
                                ay[q] += coef_p * ddy + coef_v * cvy;
                                if (DIM == 3)
                                    az[q] += coef_p * ddz + coef_v * cvz;
                            }
                        }
                    }
                }
            }
        }
    }

    if constexpr (FUSE) {
        const FkCell cc = fk_decode(c, g);
#pragma unroll
        for (int q = 0; q < KMAX; ++q) {
            if (q < k) {
                const long long s = (long long)q * cells + c;
                if (q < nq) {
                    force_step_epilogue<DIM>(
                        qx[q], qy[q], qz[q], qvx[q], qvy[q], qvz[q],
                        ax[q] - qvx[q] * sv[q], ay[q] - qvy[q] * sv[q],
                        az[q] - qvz[q] * sv[q], st, cc, g, acc_out,
                        flag_out, s, ch);
                    if constexpr (CONT == FK_CONT_SUM) {
                        rho_out[s] = ct.rho_sum_scale * sr[q];
                    } else if constexpr (CONT != FK_CONT_NONE) {
                        const float rho_q = rho[s];     // raw, reread
                        float rn = rho_q + ct.drho_scale * sr[q];
                        if (CONT == FK_CONT_RELAX) rn = ct.one_m_l * rn;
                        rho_out[s] = rn;
                    }
                } else {
                    if (CONT != FK_CONT_NONE) rho_out[s] = 0.0f;
                    acc_out[s] = FK_SENTINEL;
                    acc_out[ch + s] = FK_SENTINEL;
                    acc_out[2 * ch + s] = FK_SENTINEL;
                    acc_out[3 * ch + s] = 0.0f;
                    acc_out[4 * ch + s] = 0.0f;
                    acc_out[5 * ch + s] = 0.0f;
                    flag_out[s] = 0.0f;
                }
            }
        }
        return;
    }
    float* AX = acc_out;
    float* AY = acc_out + ch;
    float* AZ = acc_out + 2 * ch;
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
        if (q < k) {
            const long long s = (long long)q * cells + c;
            const bool live = q < nq;
            AX[s] = live ? ax[q] - qvx[q] * sv[q] : 0.0f;
            AY[s] = live ? ay[q] - qvy[q] * sv[q] : 0.0f;
            AZ[s] = (live && DIM == 3) ? az[q] - qvz[q] * sv[q] : 0.0f;
        }
    }
}

template <int KMAX, bool FUSE, int CONT>
static void launch_force(const float* fields, const float* rho, float* out,
                         float* flag, float* rho_out, const FkGeom& g,
                         float h, const FkEos& e, const FkStep& s,
                         const FkCont& ct, cudaStream_t st) {
    const unsigned blocks = (unsigned)((g.cells + 127) / 128);
    if (g.dim == 3)
        force_kernel<KMAX, 3, FUSE, CONT><<<blocks, 128, 0, st>>>(
            fields, rho, out, flag, rho_out, g, h, e, s, ct);
    else
        force_kernel<KMAX, 2, FUSE, CONT><<<blocks, 128, 0, st>>>(
            fields, rho, out, flag, rho_out, g, h, e, s, ct);
}

template <bool FUSE, int CONT>
static int force_entry(const float* fields, const float* rho, float* out,
                       float* flag, float* rho_out, const FkGeom& g, float h,
                       const FkEos& e, const FkStep& s, const FkCont& ct,
                       void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (g.k <= 8)
        launch_force<8, FUSE, CONT>(fields, rho, out, flag, rho_out, g, h, e,
                                    s, ct, st);
    else if (g.k <= 16)
        launch_force<16, FUSE, CONT>(fields, rho, out, flag, rho_out, g, h,
                                     e, s, ct, st);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

extern "C" int fk_force(const float* fields, const float* rho, float* out,
                        int dim, int k, int nx, int ny, int nz, int n_bx,
                        int py, int pz, long long cells, float h, float rho0,
                        float rho_floor, float stiffness, int tait,
                        float tait_b, float tait_gamma, float m_spiky,
                        float m_visc_sqrt, int clamp, void* stream) {
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    const FkEos e{rho0, rho_floor, stiffness, tait, tait_b, tait_gamma,
                  clamp, m_spiky, m_visc_sqrt};
    return force_entry<false, FK_CONT_NONE>(fields, rho, out, nullptr,
                                            nullptr, g, h, e, FkStep{},
                                            FkCont{}, stream);
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

extern "C" int fk_force_step(const float* fields, const float* rho,
                             float* new6, float* flag, int dim, int k,
                             int nx, int ny, int nz, int n_bx, int py,
                             int pz, long long cells, float h, float rho0,
                             float rho_floor, float stiffness, int tait,
                             float tait_b, float tait_gamma, float m_spiky,
                             float m_visc_sqrt, int clamp, const float* step,
                             int n_obs, void* stream) {
    if (n_obs < 0 || n_obs > FK_MAX_OBS) return (int)cudaErrorInvalidValue;
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    const FkEos e{rho0, rho_floor, stiffness, tait, tait_b, tait_gamma,
                  clamp, m_spiky, m_visc_sqrt};
    return force_entry<true, FK_CONT_NONE>(fields, rho, new6, flag, nullptr,
                                           g, h, e, fk_step_from(step, n_obs),
                                           FkCont{}, stream);
}

// rho: the CARRIED density (halo lanes refreshed); rho_out: next step's.
// form: FK_CONT_RATE..FK_CONT_DELTA (sph.CONT_FORMS); cont: the host float
// array of sph._cont_args, the float fields of FkCont in order.
extern "C" int fk_force_step_cont(const float* fields, const float* rho,
                                  float* new6, float* rho_out, float* flag,
                                  int dim, int k, int nx, int ny, int nz,
                                  int n_bx, int py, int pz, long long cells,
                                  float h, float rho0, float rho_floor,
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
    switch (form) {
        case FK_CONT_RATE:
            return force_entry<true, FK_CONT_RATE>(fields, rho, new6, flag,
                                                   rho_out, g, h, e, s, ct,
                                                   stream);
        case FK_CONT_RELAX:
            return force_entry<true, FK_CONT_RELAX>(fields, rho, new6, flag,
                                                    rho_out, g, h, e, s, ct,
                                                    stream);
        case FK_CONT_SUM:
            return force_entry<true, FK_CONT_SUM>(fields, rho, new6, flag,
                                                  rho_out, g, h, e, s, ct,
                                                  stream);
        case FK_CONT_DELTA:
            return force_entry<true, FK_CONT_DELTA>(fields, rho, new6, flag,
                                                    rho_out, g, h, e, s, ct,
                                                    stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
