// Kernel 4: pressure gradient + viscosity Laplacian with the EOS fused
// (plain mode: acceleration out, gravity excluded).
//
// Replaces gpufluidsimulator_tpu/ops/pallas_sph.py:_force_kernel with
// fuse_integrate = emit_movers = continuity = False.  Same arithmetic and
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
// Bound on the H100: reading the 6 position/velocity planes and the density
// planes once and writing 3 acceleration planes (10 * K * cells * 4 B,
// 388 MB at the 260,850-particle 3D dam break) outweighs the pair
// arithmetic (~32 flops for each of ~1.6e7 pairs) — bytes.  Design as in
// density.cu: one thread per cell, its valid query ranks in registers,
// each candidate (with its EOS terms) loaded and computed once and paired
// with all of them; a warp reads 32 neighbouring lanes of one row.
#include "common.cuh"

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

template <int KMAX, int DIM>
__global__ void __launch_bounds__(128)
force_kernel(const float* __restrict__ fields, const float* __restrict__ rho,
             float* __restrict__ acc_out, FkGeom g, float h, FkEos e) {
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
    int nq = 0;
    const bool interior = fk_interior(c, g);
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
        ax[q] = ay[q] = az[q] = sv[q] = 0.0f;
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
                fk_eos_terms(rho[s], e, &qp[q], &qir[q]);
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
                                const float coef_p =
                                    (qp[q] + cp) * (hr * hr * inv_r);
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

template <int KMAX>
static void launch_force(const float* fields, const float* rho, float* out,
                         const FkGeom& g, float h, const FkEos& e,
                         cudaStream_t st) {
    const unsigned blocks = (unsigned)((g.cells + 127) / 128);
    if (g.dim == 3)
        force_kernel<KMAX, 3><<<blocks, 128, 0, st>>>(fields, rho, out, g, h,
                                                      e);
    else
        force_kernel<KMAX, 2><<<blocks, 128, 0, st>>>(fields, rho, out, g, h,
                                                      e);
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
    cudaStream_t st = (cudaStream_t)stream;
    if (k <= 8)
        launch_force<8>(fields, rho, out, g, h, e, st);
    else if (k <= 16)
        launch_force<16>(fields, rho, out, g, h, e, st);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
