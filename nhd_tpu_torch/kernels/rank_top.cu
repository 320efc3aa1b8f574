// rank_top: the rank stage of a classic round's solve, for Hopper (sm_90a).
//
// Replaces the top-R ranking of the reference's fused solve+rank program:
// _rank_body (nhd_tpu/solver/kernel.py:297-317), packed in RankOut order
// (:269-295) inside get_ranked_solver (:390-418), which XLA runs as
// lax.top_k and gathers outside any Pallas kernel. One block per type row
// t of the [8, T, N] planes solve_planes.cu wrote:
//   winners   = the R largest sel = planes[0][t], equal values in
//               ascending node index (lax.top_k's order), in that order;
//   out[0]    = their sel, out[1] = their node index + node_base (a mesh
//               shard's first global row; 0 on one device);
//   out[2..5] = best_c, best_m, best_a, n_picks at them (planes 3, 4, 5, 7);
//   out[6..8] = sum over u of gpu_free and of cpu_free, and hp_free, at them.
// Every slot, val 0 included, is a function of the planes, so the kernel
// equals its plain version (kernels/reference.py rank_top) bit for bit.
// sel is unique where it is above 0 (it ends in n_global - node), so ties
// happen only at 0; the kernel orders any int32 keys all the same.
//
// Bound: the launch and a chain of dependent block steps. At the main
// path's shapes (Np = 1,024 padded nodes, R <= 512) a row needs 4 KB of
// sel, R * (4 + 2U + 1) words of gathers and 9 * R words out, well under a
// microsecond of HBM time. The design keeps the chain short
// (rank_select.cuh, shared with rank_merge.cu): up to 1,024 node rows the
// whole row is sorted in registers by 512 threads of 2 words, 10 of its
// 55 steps through shared memory, and the thread that holds a slot
// gathers and writes it with no read of its own output; past 1,024 a
// radix select finds the threshold, the winners above it are sorted
// (R log^2 R, any R) and the equal ones go to the tail slots in node
// order. This file holds the gathers: one slot's four decision-plane
// words, its 2U free words and its hugepages, all issued together.
//
// Gate: *gate* is one int32 word, always 1 on the rank's path (the rank
// runs outside the megaround: kernels.live_gate); where it is 0 the block
// writes nothing to device memory. Its load overlaps the row's.
//
// Index math: plane, node and output offsets in 64 bits; node indices in
// 32 bits (the launcher refuses an N within 1,024 of 2^31).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "rank_select.cuh"

namespace {

using namespace rank_select;

// the planes' rows (kernels.PLANES order)
constexpr int P_BEST_C = 3, P_BEST_M = 4, P_BEST_A = 5, P_N_PICKS = 7;

// Type row t's slots: a winner node n with sel *key* and its nine words.
struct TopEmit {
    const int32_t* sel;       // planes[0][t]; plane p at + p * TN
    const int32_t* gpu_free;
    const int32_t* cpu_free;
    const int32_t* hp_free;
    int32_t* out;             // out[0][t]; row r at + r * TR
    size_t TN, TR;
    int U, node_base;

    __device__ __forceinline__ Slot gather(int key, int n) const
    {
        const int32_t* at = sel + n;
        const int32_t* g = gpu_free + (size_t)n * U;
        const int32_t* c = cpu_free + (size_t)n * U;
        Slot s;
        s.w[0] = key;
        s.w[1] = n + node_base;
        s.w[2] = at[P_BEST_C * TN];
        s.w[3] = at[P_BEST_M * TN];
        s.w[4] = at[P_BEST_A * TN];
        s.w[5] = at[P_N_PICKS * TN];
        int gs = 0, cs = 0;
        for (int u = 0; u < U; ++u) {
            gs += g[u];
            cs += c[u];
        }
        s.w[6] = gs;
        s.w[7] = cs;
        s.w[8] = hp_free[n];
        return s;
    }

    __device__ __forceinline__ void write(int j, const Slot& s) const
    {
#pragma unroll
        for (int r = 0; r < RANK_ROWS; ++r) out[r * TR + j] = s.w[r];
    }
};

// WHOLE: the whole-row regime (N <= WHOLE_MAX) at THREADS threads;
// otherwise the wide regime at WIDE_THREADS under plan *wp*.
template <int THREADS, bool WHOLE>
__global__ void __launch_bounds__(THREADS) rank_top_kernel(
    const int32_t* __restrict__ planes,    // [8, T, N]
    const int32_t* __restrict__ gpu_free,  // [N, U]
    const int32_t* __restrict__ cpu_free,  // [N, U]
    const int32_t* __restrict__ hp_free,   // [N]
    const int32_t* __restrict__ gate,      // [1]: 0 = write nothing
    int32_t* __restrict__ out,             // [9, T, R]
    int T, int N, int U, int R, int node_base, WidePlan wp)
{
    const int open = *gate;  // 0: nothing reaches device memory
    extern __shared__ __align__(16) unsigned char s_dyn[];
    const int t = blockIdx.x;
    const TopEmit emit{planes + (size_t)t * N, gpu_free, cpu_free, hp_free,
                       out + (size_t)t * R, (size_t)T * N, (size_t)T * R, U,
                       node_base};
    if constexpr (WHOLE) {
        rank_whole<THREADS, WHOLE_PER>(emit.sel, N, R, open, emit);
    } else {
        rank_wide(emit.sel, N, R, open, wp, s_dyn, emit.out + 2 * emit.TR,
                  emit.TR, emit);
    }
}

// One whole-row launch at the smallest block of TH, TH / 2, .. 32
// threads that holds *threads*.
template <int TH>
cudaError_t launch_whole(int threads, cudaStream_t stream, const int32_t* planes,
                         const int32_t* gpu_free, const int32_t* cpu_free,
                         const int32_t* hp_free, const int32_t* gate, int32_t* out,
                         int T, int N, int U, int R, int node_base)
{
    if constexpr (TH > 32) {
        if (threads <= TH / 2)
            return launch_whole<TH / 2>(threads, stream, planes, gpu_free, cpu_free,
                                        hp_free, gate, out, T, N, U, R, node_base);
    }
    rank_top_kernel<TH, true><<<(unsigned)T, TH, 0, stream>>>(
        planes, gpu_free, cpu_free, hp_free, gate, out, T, N, U, R, node_base,
        WidePlan{});
    return cudaGetLastError();
}

// devices whose wide kernel may take SMEM_BYTES of dynamic shared memory
std::atomic<unsigned long long> g_wide_ready{0};

}  // namespace

extern "C" int nhd_rank_top(
    const void* planes, const void* gpu_free, const void* cpu_free,
    const void* hp_free, const void* gate, void* out, int T, int N, int U,
    int R, int node_base, int device, void* stream)
{
    if (T < 0 || N < 1 || N > INT_MAX - WIDE_THREADS || U < 0 || R < 1 || R > N)
        return (int)cudaErrorInvalidValue;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (T == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (N <= WHOLE_MAX) {
        return (int)launch_whole<WHOLE_THREADS>(
            whole_threads(N), s, (const int32_t*)planes, (const int32_t*)gpu_free,
            (const int32_t*)cpu_free, (const int32_t*)hp_free,
            (const int32_t*)gate, (int32_t*)out, T, N, U, R, node_base);
    }
    // the wide kernel's shared-memory ceiling, once per device
    err = allow_smem(rank_top_kernel<WIDE_THREADS, false>, device, g_wide_ready, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const WidePlan wp = wide_plan(N, R);
    rank_top_kernel<WIDE_THREADS, false><<<(unsigned)T, WIDE_THREADS, wp.bytes, s>>>(
        (const int32_t*)planes, (const int32_t*)gpu_free,
        (const int32_t*)cpu_free, (const int32_t*)hp_free,
        (const int32_t*)gate, (int32_t*)out, T, N, U, R, node_base, wp);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_rank_top_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
