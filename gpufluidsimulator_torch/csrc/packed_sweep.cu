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
// d = max(h - r, 0) and rinv = rsqrt(max(r^2, 1e-24)).
//
// The TPU kernel walks a (query tile, slot) grid in order, accumulating
// 128 x 128 pair tiles in VMEM scratch across grid steps, with the slots'
// candidate tiles fetched by scalar-prefetch index maps, and centers the
// coordinates per tile because it splits the sum as x_i sum(c) - sum(c x_j).
// None of that carries over.  Design: one block of 128 threads per query
// tile, one thread per query; each range is walked from lo in chunks of
// 128 candidates staged through shared memory (every thread then reads the
// same candidate: a broadcast), and the sums accumulate in float32
// registers in the direct form sum c (x_i - x_j), which needs no centering.
// Pairs outside the support (d = 0) add exactly 0 and are skipped.
//
// Bound on the H100: operations.  Every covered pair costs the distance,
// the rsqrt and the support test; the pairs inside the support add the two
// coefficients and six multiply-adds.  The bytes are small: each packed
// row is read once per query tile whose ranges cover it (from L2 mostly).
#include "common.cuh"

#define FK_TQ 128

__global__ void __launch_bounds__(FK_TQ)
packed_sweep_kernel(const float4* __restrict__ f, const int* __restrict__ desc,
                    float* __restrict__ out, float h, float k1, float k2) {
    __shared__ float4 cand_a[FK_TQ];   // x, y, z, vx of the staged rows
    __shared__ float4 cand_b[FK_TQ];   // vy, vz, a, ir
    const int t = blockIdx.x;
    const long long i = (long long)t * FK_TQ + threadIdx.x;
    const float4 qa = f[2 * i];
    const float4 qb = f[2 * i + 1];
    const float kir = k2 * qb.w;
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int r = 0; r < 3; ++r) {
        const int lo = desc[t * 8 + 2 * r];
        const int hi = desc[t * 8 + 2 * r + 1];
        for (int c0 = lo; c0 < hi; c0 += FK_TQ) {
            const long long j = (long long)c0 + threadIdx.x;
            if (j < hi) {
                cand_a[threadIdx.x] = f[2 * j];
                cand_b[threadIdx.x] = f[2 * j + 1];
            }
            __syncthreads();
            const int m = min(FK_TQ, hi - c0);
            for (int k = 0; k < m; ++k) {
                const float4 ca = cand_a[k];
                const float dx = qa.x - ca.x;
                const float dy = qa.y - ca.y;
                const float dz = qa.z - ca.z;
                const float r2 = dx * dx + dy * dy + dz * dz;
                const float rinv = rsqrtf(fmaxf(r2, 1e-24f));
                const float d = fmaxf(h - r2 * rinv, 0.f);
                if (r2 > 1e-16f && d > 0.f) {
                    const float4 cb = cand_b[k];
                    const float cp = k1 * (cb.z + qb.z) * (d * d) * rinv;
                    const float cv = kir * cb.w * d;
                    ax += cp * dx + cv * (ca.w - qa.w);
                    ay += cp * dy + cv * (cb.x - qb.x);
                    az += cp * dz + cv * (cb.y - qb.y);
                }
            }
            __syncthreads();
        }
    }
    out[3 * i] = ax;
    out[3 * i + 1] = ay;
    out[3 * i + 2] = az;
}

extern "C" int fk_sweep_packed(const float* f, const int* desc, float* out,
                               int q, float h, float k1, float k2,
                               void* stream) {
    if (q > 0)
        packed_sweep_kernel<<<q, FK_TQ, 0, (cudaStream_t)stream>>>(
            (const float4*)f, desc, out, h, k1, k2);
    return (int)cudaGetLastError();
}
