// Kernel 7 (+ 6): flagged slots' channel values -> dense rows.
//
// Replaces gpufluidsimulator_tpu/ops/inc.py:_compact_kernel together with
// the gpufluidsimulator_tpu/ops/route.py:_stitch_kernel pass that
// compact_flagged runs after it.  Contract (inc.py:440-455): for the slots
// with flag > 0.5, out[c, j] = channel_c[slot_j] for j < min(count, cap),
// and 0 past it; the count of flagged slots is returned beside it.  The TPU
// kernel routes each 8,192-slot tile through butterfly networks into
// per-tile strips (it has no per-lane scatter) and the stitch kernel joins
// the strips at prefix offsets.  On Hopper that is a stream compaction.
// Rows come out in slot order (the reference's order is two-level tile
// order; no consumer relies on either, inc.py:452-454).  The channels are
// passed as base pointers, so a (C, K * cells) plane stack is read in place
// and no channel is copied (the reference's round-5 lesson, inc.py:1056).
//
// Bound on the H100: bytes — the flag plane read once (K * cells * 4 B,
// 58.7 MB at the 1,197,770-particle double dam break), the C values of the
// m flagged slots read and the (C, cap) output written: 0.019 ms at 1.5%
// movers.
//
// The first design ran three kernels (count, a one-block serial scan of
// the 3,584 chunk counts, write) after a torch.zeros of the output: the
// flag plane crossed HBM twice and the write pass held one 4-byte load per
// thread between two barriers, 0.12058 ms against 0.10138 for nonzero +
// index (H100 80GB HBM3, 700 W).
//
// This design is one pass, Merrill and Garland's decoupled look-back: each
// block takes its 4,096-slot chunk by an atomic ticket (so chunks are
// taken in order and a block only ever waits on blocks that started
// before it), reads its flags once as float4, four per thread (those of
// chunk blockIdx.x, loaded while the ticket is in flight, and read again
// only if the ticket differs), ranks them with warp scans and a prefix
// over its 8 warps, publishes its aggregate, takes its offset from its
// predecessors' published aggregates and prefixes (warp 0 reads 4 x 32 of
// them at a time), and copies the C values of its flagged slots.  The
// scratch (ticket, epoch, one status word per chunk) is kept across calls
// and never cleared by a launch: a status word carries the epoch it was
// written in, and the block that takes the last ticket resets the ticket
// and advances the epoch.  It also writes total and min(total, cap).  The
// zero tail stays one memset of the output before the kernel: inside the
// kernel only the last block knows the count, and it would write the ~4
// MB tail alone.  One memset and one kernel a call, where the first
// design launched a memset and three kernels.
//
// Measured (H100 80GB HBM3 at 700.00 W, evolved double dam break): 0.052
// to 0.060 ms of device time a step (scripts/torch_profile_step.py),
// 2.7 to 3.2x the bound; 0.099 ms a call end to end (CUDA events)
// against 0.109 for nonzero + index, both bound by the host's dispatch.
#include <cstdint>

#include "common.cuh"

#define CMP_THREADS 256
#define CMP_WARPS (CMP_THREADS / 32)
#define CMP_ITERS 4                              // float4 loads a thread
#define CMP_WARP_ITEMS (32 * 4 * CMP_ITERS)      // 512 slots a warp
#define CMP_CHUNK (CMP_WARPS * CMP_WARP_ITEMS)   // 4,096 slots a block
#define CMP_LOOK 4                               // 32-chunk windows a read
#define CMP_MAX_CH 8
#define CMP_EPOCH_MASK 0x3fffffffu
#define CMP_AGGREGATE 1u
#define CMP_PREFIX 2u

struct FkChans {
    const float* p[CMP_MAX_CH];
};

// The status words carry their whole payload, so relaxed loads and stores
// do: no other data is published through them.
__device__ __forceinline__ unsigned long long cmp_load(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ bool cmp_ready(unsigned long long v,
                                          unsigned epoch) {
    const unsigned hi = (unsigned)(v >> 32);
    return (hi >> 2) == epoch && (hi & 3u) != 0u;
}

__device__ __forceinline__ void cmp_publish(unsigned long long* p,
                                            unsigned epoch, unsigned kind,
                                            int value) {
    const unsigned long long v =
        ((unsigned long long)((epoch << 2) | kind) << 32) | (unsigned)value;
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int cmp_warp_sum(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Offset of this chunk's first row: the sum of its predecessors' counts.
// Warp 0 reads CMP_LOOK windows of 32 predecessors' status words at once,
// nearest first, and stops at the nearest inclusive prefix.
__device__ __forceinline__ int cmp_look_back(
        const unsigned long long* status, int chunk, unsigned epoch,
        int lane) {
    int excl = 0;
    for (long long j = chunk - 1;; j -= 32 * CMP_LOOK) {
        unsigned long long word[CMP_LOOK];
#pragma unroll
        for (int q = 0; q < CMP_LOOK; ++q) {
            const long long idx = j - 32 * q - lane;
            word[q] = idx >= 0 ? cmp_load(status + idx)
                               : (unsigned long long)((epoch << 2)
                                                      | CMP_PREFIX) << 32;
        }
#pragma unroll
        for (int q = 0; q < CMP_LOOK; ++q)
            while (!cmp_ready(word[q], epoch))
                word[q] = cmp_load(status + (j - 32 * q - lane));
#pragma unroll
        for (int q = 0; q < CMP_LOOK; ++q) {
            const int val = (int)(unsigned)word[q];
            const unsigned pm = __ballot_sync(
                0xffffffffu, ((unsigned)(word[q] >> 32) & 3u) == CMP_PREFIX);
            if (pm != 0u) {
                const int first = __ffs(pm) - 1;
                return excl + cmp_warp_sum(lane <= first ? val : 0);
            }
            excl += cmp_warp_sum(val);
        }
    }
}

// This thread's 16 flags of a chunk, as bit 4 * it + e: four float4
// rounds, a warp's 512 slots coalesced along the lanes.
__device__ __forceinline__ unsigned cmp_bits(const float* __restrict__ flags,
                                             long long m, long long wbase,
                                             int lane) {
    unsigned bits = 0;
#pragma unroll
    for (int it = 0; it < CMP_ITERS; ++it) {
        const long long i = wbase + it * 128 + lane * 4;
        float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i + 4 <= m) {
            f = __ldg(reinterpret_cast<const float4*>(flags + i));
        } else if (i < m) {
            f.x = flags[i];
            if (i + 1 < m) f.y = flags[i + 1];
            if (i + 2 < m) f.z = flags[i + 2];
        }
        bits |= ((unsigned)(f.x > 0.5f) | (unsigned)(f.y > 0.5f) << 1
                 | (unsigned)(f.z > 0.5f) << 2 | (unsigned)(f.w > 0.5f) << 3)
                << (4 * it);
    }
    return bits;
}

// scratch: ticket, epoch, then one 64-bit status word per chunk: (epoch <<
// 2 | kind) above the chunk's aggregate or inclusive prefix.  counts: total
// and min(total, cap).
__global__ void __launch_bounds__(CMP_THREADS)
compact_kernel(FkChans chans, int n_ch, const float* __restrict__ flags,
               long long m, float* __restrict__ out, int cap,
               int* __restrict__ scratch, int nb, int* __restrict__ counts) {
    __shared__ int s_chunk;
    __shared__ unsigned s_epoch;
    __shared__ int s_warp[CMP_WARPS];
    __shared__ int s_excl;
    unsigned long long* status =
        reinterpret_cast<unsigned long long*>(scratch + 2);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int w = tid >> 5;
    if (tid == 0) {
        s_epoch = *(volatile unsigned*)(scratch + 1);
        s_chunk = atomicAdd(scratch, 1);
    }
    // the flags of chunk blockIdx.x, loaded while the ticket is taken:
    // blocks start in index order, so the ticket almost always matches
    unsigned bits = cmp_bits(flags, m, (long long)blockIdx.x * CMP_CHUNK
                             + w * CMP_WARP_ITEMS, lane);
    __syncthreads();
    const int chunk = s_chunk;
    const unsigned epoch = s_epoch;
    const long long wbase = (long long)chunk * CMP_CHUNK + w * CMP_WARP_ITEMS;
    if (chunk != (int)blockIdx.x)                    // block-uniform
        bits = cmp_bits(flags, m, wbase, lane);

    // rank inside the warp: slots in order (round, lane, element)
    int woff[CMP_ITERS];
    int wtot = 0;
#pragma unroll
    for (int it = 0; it < CMP_ITERS; ++it) {
        const int c = __popc((bits >> (4 * it)) & 0xfu);
        int incl = c;
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += t;
        }
        woff[it] = wtot + incl - c;
        wtot += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_warp[w] = wtot;
    __syncthreads();
    int wpre = 0, agg = 0;
#pragma unroll
    for (int j = 0; j < CMP_WARPS; ++j) {
        wpre += j < w ? s_warp[j] : 0;
        agg += s_warp[j];
    }

    // publish the aggregate, look back (warp 0), publish the prefix.  The
    // block that took the last ticket finishes after every other block has
    // published, so after each has read the epoch: it resets the ticket
    // and advances the epoch for the next call.
    if (w == 0) {
        int excl = 0;
        if (chunk == 0) {
            if (lane == 0) cmp_publish(status, epoch, CMP_PREFIX, agg);
        } else {
            if (lane == 0)
                cmp_publish(status + chunk, epoch, CMP_AGGREGATE, agg);
            excl = cmp_look_back(status, chunk, epoch, lane);
            if (lane == 0)
                cmp_publish(status + chunk, epoch, CMP_PREFIX, excl + agg);
        }
        if (lane == 0) {
            s_excl = excl;
            if (chunk == nb - 1) {
                const int total = excl + agg;
                counts[0] = total;
                counts[1] = min(total, cap);
                __threadfence();   // the look-back's reads before the reset
                scratch[0] = 0;
                scratch[1] = (int)((epoch + 1u) & CMP_EPOCH_MASK);
            }
        }
    }
    __syncthreads();
    if (wtot == 0) return;                           // warp-uniform

    const int off = s_excl + wpre;
#pragma unroll
    for (int it = 0; it < CMP_ITERS; ++it) {
        const unsigned b = (bits >> (4 * it)) & 0xfu;
        if (b == 0u) continue;
        const long long i = wbase + it * 128 + lane * 4;
        int o = off + woff[it];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (!((b >> e) & 1u)) continue;
            if (o < cap) {
#pragma unroll
                for (int c = 0; c < CMP_MAX_CH; ++c)   // constant indices:
                    if (c < n_ch)                     // chans stays in
                        out[(long long)c * cap + o] = chans.p[c][i + e];
            }
            ++o;
        }
    }
}

// chans: host array of n_ch device pointers, each to m floats.  flags:
// 16-byte aligned.  out: (n_ch, cap), zeroed here.  scratch: the
// wrapper's persistent 2 + 2 nb ints (inc.compact_scratch), nb = ceil(m /
// CMP_CHUNK).  counts: 2 ints, total and min(total, cap).
extern "C" int fk_compact(const float* const* chans, int n_ch,
                          const float* flags, long long m, float* out,
                          int cap, int* scratch, int nb, int* counts,
                          void* stream) {
    if (n_ch < 1 || n_ch > CMP_MAX_CH || m < 0
        || nb != (m + CMP_CHUNK - 1) / CMP_CHUNK
        || reinterpret_cast<uintptr_t>(flags) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    FkChans ch{};
    for (int c = 0; c < n_ch; ++c) ch.p[c] = chans[c];
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * n_ch * cap, st);
    if (err != cudaSuccess) return (int)err;
    if (nb == 0) {
        err = cudaMemsetAsync(counts, 0, 2 * sizeof(int), st);
        return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
    }
    compact_kernel<<<nb, CMP_THREADS, 0, st>>>(ch, n_ch, flags, m, out, cap,
                                               scratch, nb, counts);
    return (int)cudaGetLastError();
}
