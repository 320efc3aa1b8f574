// spec_fill: the megaround's balanced fill, for Hopper (sm_90a).
//
// Replaces the type-side fill of the speculative megaround's loop body
// (nhd_tpu/solver/speculate.py:406-448 and the need update at :529). One
// block per global type row t; the row's elected nodes are those whose
// plan elect equals t:
//   n_win = their count, fair = ceil(need[t] / max(n_win, 1)),
//   capw  = min(max(cap, 1), fair) at each of them,
//   prefix = exclusive cumsum of capw over the pref-2 winners by node
//            index, then (after all of them) over the pref-1 winners,
//   take  = clip(need[t] - prefix, 0, capw)   -> plan's count row,
// and need[t] -= sum(take); status[0] (progress) is set to 1 when the row
// took anything. A node is elected by one row at most, so blocks write
// disjoint plan entries.
//
// The node axis is a sequential scan on the TPU's single core; here the
// block walks it in tiles of THREADS nodes, a warp-shuffle scan inside each
// tile and a running carry across tiles, in three passes (winner count, the
// pref-2 total, the scans). Bound: the launch at the main path's sizes;
// the passes re-read the plan from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ int block_sum(int v, int* s_red)
{
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) s_red[warp] = v;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < WARPS; ++w) total += s_red[w];
    return total;
}

// inclusive scan of (x, y) across the block; returns the tile totals
__device__ __forceinline__ int2 block_scan2(int& x, int& y, int2* s_scan)
{
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int o = 1; o < 32; o <<= 1) {
        const int xo = __shfl_up_sync(0xffffffffu, x, o);
        const int yo = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) { x += xo; y += yo; }
    }
    __syncthreads();
    if (lane == 31) s_scan[warp] = make_int2(x, y);
    __syncthreads();
    int2 before = make_int2(0, 0), total = make_int2(0, 0);
    for (int w = 0; w < WARPS; ++w) {
        if (w < warp) { before.x += s_scan[w].x; before.y += s_scan[w].y; }
        total.x += s_scan[w].x;
        total.y += s_scan[w].y;
    }
    x += before.x;
    y += before.y;
    return total;
}

__global__ void __launch_bounds__(THREADS) spec_fill_kernel(
    int32_t* __restrict__ plan,    // [7, N]
    int32_t* __restrict__ status,  // [TT + 1]
    int TT, int N)
{
    __shared__ int s_red[WARPS];
    __shared__ int2 s_scan[WARPS];
    const int t = blockIdx.x;
    const int32_t* elect = plan;
    const int32_t* hi = plan + (size_t)N;
    const int32_t* cap = plan + 2 * (size_t)N;
    int32_t* count = plan + 6 * (size_t)N;
    const int need = status[1 + t];

    int mine = 0;
    for (int n = threadIdx.x; n < N; n += THREADS) mine += elect[n] == t;
    const int n_win = block_sum(mine, s_red);
    if (n_win == 0) return;  // no winner: nothing taken, need unchanged
    const int fair = (need + n_win - 1) / n_win;  // need > 0 for a winner

    int hi_sum = 0;
    for (int n = threadIdx.x; n < N; n += THREADS)
        if (elect[n] == t && hi[n]) hi_sum += min(max(cap[n], 1), fair);
    const int total_hi = block_sum(hi_sum, s_red);

    int carry_hi = 0, carry_lo = 0, taken = 0;
    for (int n0 = 0; n0 < N; n0 += THREADS) {
        const int n = n0 + threadIdx.x;
        const bool win = n < N && elect[n] == t;
        const bool is_hi = win && hi[n] != 0;
        const int capw = win ? min(max(cap[n], 1), fair) : 0;
        int x = is_hi ? capw : 0;
        int y = win && !is_hi ? capw : 0;
        const int x0 = x, y0 = y;
        const int2 tot = block_scan2(x, y, s_scan);
        if (win) {
            const int prefix = is_hi ? carry_hi + x - x0
                                     : total_hi + carry_lo + y - y0;
            const int take = min(max(need - prefix, 0), capw);
            count[n] = take;
            taken += take;
        }
        carry_hi += tot.x;
        carry_lo += tot.y;
    }
    const int total = block_sum(taken, s_red);
    if (threadIdx.x == 0) {
        status[1 + t] = need - total;
        if (total > 0) status[0] = 1;
    }
}

}  // namespace

extern "C" int nhd_spec_fill(
    void* plan, void* status, int TT, int N, int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (TT == 0 || N == 0) return 0;
    spec_fill_kernel<<<(unsigned)TT, THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)plan, (int32_t*)status, TT, N);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_spec_fill_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
