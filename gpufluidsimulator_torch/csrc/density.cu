// Kernel 3: poly6 summation density over the 3^d cell stencil.
//
// Replaces gpufluidsimulator_tpu/ops/pallas_sph.py:_density_kernel.  For
// every valid (x < SENTINEL/2) rank of an interior cell:
//   rho = poly6_coef * m * sum over the 3^d neighbour cells' valid ranks of
//         max(h^2 - r^2, 0)^3                                 (self included)
// and 0 on every other slot (the TPU kernel leaves those undefined; the port
// defines them as 0).  The TPU kernel bounds its rank loops by per-block
// occupancy maxima (occ_q/occ_s); here each thread stops at the first
// sentinel rank of each cell, since ranks are dense from 0.
//
// Bound on the H100: the output is written for every slot (K * cells * 4 B,
// 38.8 MB at the 260,850-particle 3D dam break), which outweighs the pair
// arithmetic (~13 flops for each of ~1.6e7 pairs) — bytes.  Design: one
// thread per cell; the cell's valid query ranks stay in registers
// (KMAX-wide, unrolled), and each candidate is loaded once and compared
// against all of them, so candidate traffic does not scale with occupancy.
// A warp is 32 neighbouring lanes of one row, so every candidate load is a
// coalesced row read.  Empty and ghost cells only write zeros.
#include "common.cuh"

template <int KMAX, int DIM>
__global__ void __launch_bounds__(128)
density_kernel(const float* __restrict__ pos, float* __restrict__ rho,
               FkGeom g, float h2, float c_poly6) {
    const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (c >= g.cells) return;
    const long long cells = g.cells;
    const int k = g.k;
    const float* X = pos;
    const float* Y = pos + (long long)k * cells;
    const float* Z = pos + 2LL * k * cells;

    float qx[KMAX], qy[KMAX], qz[KMAX], acc[KMAX];
    int nq = 0;
    const bool interior = fk_interior(c, g);
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
        acc[q] = 0.0f;
        qx[q] = qy[q] = qz[q] = 0.0f;
        if (interior && q < k && q == nq) {
            const float xv = X[(long long)q * cells + c];
            if (xv < FK_HALF_SENTINEL) {
                qx[q] = xv;
                qy[q] = Y[(long long)q * cells + c];
                if (DIM == 3) qz[q] = Z[(long long)q * cells + c];
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
#pragma unroll
                        for (int q = 0; q < KMAX; ++q) {
                            if (q < nq) {
                                const float ddx = qx[q] - cx;
                                const float ddy = qy[q] - cy;
                                float r2 = ddx * ddx + ddy * ddy;
                                if (DIM == 3) {
                                    const float ddz = qz[q] - cz;
                                    r2 = r2 + ddz * ddz;
                                }
                                const float d = fmaxf(h2 - r2, 0.0f);
                                acc[q] += d * d * d;
                            }
                        }
                    }
                }
            }
        }
    }

#pragma unroll
    for (int q = 0; q < KMAX; ++q)
        if (q < k)
            rho[(long long)q * cells + c] = q < nq ? c_poly6 * acc[q] : 0.0f;
}

template <int KMAX>
static void launch_density(const float* pos, float* rho, const FkGeom& g,
                           float h2, float c_poly6, cudaStream_t st) {
    const unsigned blocks = (unsigned)((g.cells + 127) / 128);
    if (g.dim == 3)
        density_kernel<KMAX, 3><<<blocks, 128, 0, st>>>(pos, rho, g, h2,
                                                        c_poly6);
    else
        density_kernel<KMAX, 2><<<blocks, 128, 0, st>>>(pos, rho, g, h2,
                                                        c_poly6);
}

extern "C" int fk_density(const float* pos, float* rho, int dim, int k,
                          int nx, int ny, int nz, int n_bx, int py, int pz,
                          long long cells, float h2, float c_poly6,
                          void* stream) {
    const FkGeom g{dim, k, nx, ny, nz, n_bx, py, pz, cells};
    cudaStream_t st = (cudaStream_t)stream;
    if (k <= 8)
        launch_density<8>(pos, rho, g, h2, c_poly6, st);
    else if (k <= 16)
        launch_density<16>(pos, rho, g, h2, c_poly6, st);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
