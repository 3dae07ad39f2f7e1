// Kernel 7 (+ 6): flagged slots' channel values -> dense rows.
//
// Replaces gpufluidsimulator_tpu/ops/inc.py:_compact_kernel together with
// the gpufluidsimulator_tpu/ops/route.py:_stitch_kernel pass that
// compact_flagged runs after it.  Contract (inc.py:440-455): for the slots
// with flag > 0.5, out[c, j] = channel_c[slot_j] for j < min(count, cap),
// and 0 past it; the count of flagged slots is returned beside it.  The TPU
// kernel routes each 8,192-slot tile through butterfly networks into
// per-tile strips (it has no per-lane scatter) and the stitch kernel joins
// the strips at prefix offsets.  On Hopper that is a stream compaction:
//   pass 1 (count): each block counts the flags of its 4,096-slot chunk;
//   pass 2 (scan):  one block turns the chunk counts into exclusive
//                   offsets and writes the total and min(total, cap);
//   pass 3 (write): each block re-reads its flags in order, ranks them
//                   with a warp ballot + popc and a prefix over its 8
//                   warps, and copies the C channel values of every flagged
//                   slot to out[:, offset] while offset < cap.
// Rows come out in slot order (the reference's order is two-level tile
// order; no consumer relies on either, inc.py:452-454).  The channels are
// passed as base pointers, so a (C, K * cells) plane stack is read in place
// and no channel is copied (the reference's round-5 lesson, inc.py:1056).
//
// Bound on the H100: bytes — the flag plane read once (K * cells * 4 B,
// 58.7 MB at the 1,197,770-particle double dam break), the C values of the
// m flagged slots read and the (C, cap) output written: 0.02 ms at 1% movers.
// Design: the flags are read twice (passes 1 and 3) instead of keeping a
// per-slot offset array, which would cost more bytes than the second read;
// the value reads are scattered but touch only flagged slots.
#include "common.cuh"

#define CMP_THREADS 256
#define CMP_ITERS 16
#define CMP_CHUNK (CMP_THREADS * CMP_ITERS)
#define CMP_MAX_CH 8

struct FkChans {
    const float* p[CMP_MAX_CH];
};

__global__ void __launch_bounds__(CMP_THREADS)
compact_count_kernel(const float* __restrict__ flags, long long m,
                     int* __restrict__ block_counts) {
    const long long base = (long long)blockIdx.x * CMP_CHUNK;
    int cnt = 0;
#pragma unroll 4
    for (int it = 0; it < CMP_ITERS; ++it) {
        const long long i = base + it * CMP_THREADS + threadIdx.x;
        cnt += (i < m && flags[i] > 0.5f) ? 1 : 0;
    }
    const int total = fk_block_sum(cnt);
    if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

// One block of 1024 threads: exclusive scan of nb chunk counts in place,
// then total -> tail[0] and min(total, cap) -> tail[1].
__global__ void __launch_bounds__(1024)
compact_scan_kernel(int* __restrict__ counts, int nb, int cap,
                    int* __restrict__ tail) {
    __shared__ int warp_tot[32];
    __shared__ int carry_s;
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    if (threadIdx.x == 0) carry_s = 0;
    __syncthreads();
    for (int base = 0; base < nb; base += 1024) {
        const int i = base + threadIdx.x;
        const int v = i < nb ? counts[i] : 0;
        int incl = v;
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += t;
        }
        if (lane == 31) warp_tot[w] = incl;
        __syncthreads();
        int woff = 0;
        for (int j = 0; j < w; ++j) woff += warp_tot[j];
        const int carry = carry_s;
        if (i < nb) counts[i] = carry + woff + incl - v;
        __syncthreads();
        if (threadIdx.x == 1023) carry_s = carry + woff + incl;
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        tail[0] = carry_s;
        tail[1] = min(carry_s, cap);
    }
}

__global__ void __launch_bounds__(CMP_THREADS)
compact_write_kernel(FkChans chans, int n_ch, const float* __restrict__ flags,
                     long long m, const int* __restrict__ offsets,
                     float* __restrict__ out, int cap) {
    __shared__ int warp_tot[CMP_THREADS / 32];
    const long long base = (long long)blockIdx.x * CMP_CHUNK;
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    int off = offsets[blockIdx.x];
    for (int it = 0; it < CMP_ITERS; ++it) {
        const long long i = base + it * CMP_THREADS + threadIdx.x;
        const bool f = i < m && flags[i] > 0.5f;
        const unsigned mask = __ballot_sync(0xffffffffu, f);
        if (lane == 0) warp_tot[w] = __popc(mask);
        __syncthreads();
        int woff = 0, tot = 0;
#pragma unroll
        for (int j = 0; j < CMP_THREADS / 32; ++j) {
            const int t = warp_tot[j];
            woff += j < w ? t : 0;
            tot += t;
        }
        if (f) {
            const int o = off + woff + __popc(mask & below);
            if (o < cap)
                for (int c = 0; c < n_ch; ++c)
                    out[(long long)c * cap + o] = chans.p[c][i];
        }
        off += tot;
        __syncthreads();
    }
}

// chans: host array of n_ch device pointers, each to m floats.
// scratch: nb + 2 ints (nb = ceil(m / 4096) chunk offsets, then total and
// min(total, cap)).  out: (n_ch, cap), zeroed by the caller.
extern "C" int fk_compact(const float* const* chans, int n_ch,
                          const float* flags, long long m, float* out,
                          int cap, int* scratch, int nb, void* stream) {
    if (n_ch < 1 || n_ch > CMP_MAX_CH || nb != (m + CMP_CHUNK - 1) / CMP_CHUNK)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    FkChans ch{};
    for (int c = 0; c < n_ch; ++c) ch.p[c] = chans[c];
    compact_count_kernel<<<nb, CMP_THREADS, 0, st>>>(flags, m, scratch);
    compact_scan_kernel<<<1, 1024, 0, st>>>(scratch, nb, cap, scratch + nb);
    compact_write_kernel<<<nb, CMP_THREADS, 0, st>>>(ch, n_ch, flags, m,
                                                     scratch, out, cap);
    return (int)cudaGetLastError();
}
