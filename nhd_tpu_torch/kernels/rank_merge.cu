// rank_merge: the top R across a mesh's shards, for Hopper (sm_90a).
//
// On a node-sharded mesh the reference runs its fused solve+rank program
// (nhd_tpu/solver/kernel.py get_ranked_solver_mesh, the lax.top_k of
// _rank_body at :297-317 over the sharded node axis) under GSPMD, which
// inserts the cross-shard top-k. The port ranks each shard with
// rank_top.cu (its top min(R, shard rows), indices made global) and joins
// the shards' candidates in shard order; this kernel takes that [9, T, M]
// tensor and, one block per type row t:
//   winners = the R largest cand[0][t], equal values in ascending position
//             (lax.top_k's order), in that order;
//   out[r]  = cand[r][t] at the winners, for each of the nine rows.
// A shard's zero-valued candidates are its lowest-index zero nodes in
// ascending order and the shards come in order, so the val-0 slots are
// the unsharded rank's as well: a shard of k = min(R, rows) candidates
// holds at least as many zero nodes as the global top R takes from it.
// The kernel equals its plain version (kernels/reference.py rank_merge)
// bit for bit.
//
// Bound: the launch. At cfg4 over 4 shards (M = 4 * 256, R = 512) a row
// needs 4 KB of keys, 9 * R words gathered and 9 * R written. The
// selection and the sort are rank_top.cu's (rank_select.cuh): up to 1,024
// candidates the whole row sorted in registers, past that a radix select,
// the winners above the threshold sorted and the equal ones placed in
// order. Each winner's key is its row-0 word; its other eight words are
// copied by the thread that holds the slot, their loads issued together.
//
// Gate: *gate* is one int32 word, always 1 on the rank's path
// (kernels.live_gate); where it is 0 the block writes nothing to device
// memory. Its load overlaps the row's.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "rank_select.cuh"

namespace {

using namespace rank_select;

// Type row t's slots: the candidate at position p with row-0 *key*.
struct MergeEmit {
    const int32_t* src;  // cand[0][t]; row r at + r * TM
    int32_t* out;        // out[0][t]; row r at + r * TR
    size_t TM, TR;

    __device__ __forceinline__ Slot gather(int key, int p) const
    {
        Slot s;
        s.w[0] = key;
#pragma unroll
        for (int r = 1; r < RANK_ROWS; ++r) s.w[r] = src[r * TM + p];
        return s;
    }

    __device__ __forceinline__ void write(int j, const Slot& s) const
    {
#pragma unroll
        for (int r = 0; r < RANK_ROWS; ++r) out[r * TR + j] = s.w[r];
    }
};

template <int THREADS, bool WHOLE>
__global__ void __launch_bounds__(THREADS) rank_merge_kernel(
    const int32_t* __restrict__ cand,  // [9, T, M]
    const int32_t* __restrict__ gate,  // [1]: 0 = write nothing
    int32_t* __restrict__ out,         // [9, T, R]
    int T, int M, int R, WidePlan wp)
{
    const int open = *gate;  // 0: nothing reaches device memory
    extern __shared__ __align__(16) unsigned char s_dyn[];
    const int t = blockIdx.x;
    const MergeEmit emit{cand + (size_t)t * M, out + (size_t)t * R,
                         (size_t)T * M, (size_t)T * R};
    if constexpr (WHOLE) {
        rank_whole<THREADS, WHOLE_PER>(emit.src, M, R, open, emit);
    } else {
        rank_wide(emit.src, M, R, open, wp, s_dyn, emit.out + 2 * emit.TR,
                  emit.TR, emit);
    }
}

// One whole-row launch at the smallest block of TH, TH / 2, .. 32
// threads that holds *threads*.
template <int TH>
cudaError_t launch_whole(int threads, cudaStream_t stream, const int32_t* cand,
                         const int32_t* gate, int32_t* out, int T, int M, int R)
{
    if constexpr (TH > 32) {
        if (threads <= TH / 2)
            return launch_whole<TH / 2>(threads, stream, cand, gate, out, T, M, R);
    }
    rank_merge_kernel<TH, true><<<(unsigned)T, TH, 0, stream>>>(
        cand, gate, out, T, M, R, WidePlan{});
    return cudaGetLastError();
}

// devices whose wide kernel may take SMEM_BYTES of dynamic shared memory
std::atomic<unsigned long long> g_wide_ready{0};

}  // namespace

extern "C" int nhd_rank_merge(
    const void* cand, const void* gate, void* out, int T, int M, int R,
    int device, void* stream)
{
    if (T < 0 || M < 1 || M > INT_MAX - WIDE_THREADS || R < 1 || R > M)
        return (int)cudaErrorInvalidValue;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (T == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (M <= WHOLE_MAX)
        return (int)launch_whole<WHOLE_THREADS>(
            whole_threads(M), s, (const int32_t*)cand,
            (const int32_t*)gate, (int32_t*)out, T, M, R);
    // the wide kernel's shared-memory ceiling, once per device
    err = allow_smem(rank_merge_kernel<WIDE_THREADS, false>, device, g_wide_ready, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const WidePlan wp = wide_plan(M, R);
    rank_merge_kernel<WIDE_THREADS, false><<<(unsigned)T, WIDE_THREADS, wp.bytes, s>>>(
        (const int32_t*)cand, (const int32_t*)gate, (int32_t*)out, T, M, R, wp);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_rank_merge_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
