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
// disjoint plan entries. The count row comes in as spec_elect wrote it (0
// everywhere), and only winners' entries are written.
//
// Bound: the launch at the main path's sizes (4 KB of plan a row), then a
// chain of dependent steps inside the block. The design keeps that chain
// short (each choice timed on an H100 at cfg4's and cfg3's megaround
// shapes by kernel_variants.py, the variant named):
//   * a row whose need is <= 0 leaves before its first barrier: spec_elect
//     elects no node for it (its eligibility asks need > 0), so it has no
//     winner, and the plain version leaves its need and the count row as
//     they are. The need is read beside the tile's plan loads, not before
//     them, so a live row waits for one round trip, not two: reading it
//     first timed 0.0001-0.0003 ms slower (needfirst); a dead row's block
//     runs beside the live ones, so its unused loads cost no time;
//   * a thread owns PER = 4 contiguous nodes of a TILE = 1024-node tile and
//     issues its elect, hi and cap loads together before using any, as
//     int4 loads where the row's start is 16-byte aligned and the four
//     nodes lie below N, scalar loads at the ragged tail (and for rows of
//     an N that is no multiple of 4). Up to N = TILE (the main path's
//     Np = 1024) every plan word is read once and then kept in registers.
//     Scalar loads throughout timed level (scalar); 1024 threads of one
//     node, 128 of eight and 32 of 32 timed 0.0016, 0.0000-0.0003 and
//     0.0009 ms slower (t1024, t128, t32);
//   * the winner count takes one barrier: a __reduce_add_sync per warp,
//     one shared word per warp, then every thread sums the WARPS words and
//     computes fair itself;
//   * the pref-2 and pref-1 prefixes come out of one scan of (hi, lo)
//     pairs: the thread's own sums, a warp shuffle scan of the pair, one
//     shared pair per warp, a second barrier. The warp offsets and the
//     row's pref-2 total (total_hi) both come from that shared array, so
//     there is no separate pref-2 pass; each thread then walks its nodes
//     with running exclusive prefixes;
//   * there is no closing reduction of the takes: over one row they
//     telescope, sum(take) = min(need, total_hi + total_lo), because the
//     prefixes are exclusive, capw >= 1 at every winner and need > 0.
//     Nothing overflows while need + N < 2^31, since sum(capw) <=
//     n_win * fair < need + n_win. Thread 0 writes the need and the flag
//     (tests/test_torch_fill.py holds the sum on the sweeps and on cfg4's
//     megaround, and that no node elects a row without need);
//   * the count row is written with scalar stores at winners only: the
//     blocks of other rows write other winners of the same row, so a
//     vector store would overwrite another block's entry.
// Past one tile the block first counts over every tile (re-reading elect;
// tile 0 stays in registers), then sums the pref-2 capw over every tile
// (one more barrier), then scans tile by tile with a running carry, one
// barrier a tile (the per-warp pairs double-buffered by tile parity).
//
// Index math: row offsets in 64 bits (size_t r * N), node indices in 32
// bits; the launcher refuses an N above 2^31 - 1 - TILE, where a tile's
// last node index would overflow.

// Gate: *gate* is one int32 word of the megaround's control tensor (its
// alive flag, written by spec_gate.cu). Where it is 0 every block returns
// before it writes device memory: a dead iteration of the fixed-trip
// megaround. Its load issues beside the kernel's first loads and is
// tested after them, so a live launch waits for no extra round trip.
// Outside the megaround it is a word that is always 1.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;                 // contiguous nodes a thread
constexpr bool VECTOR = true;          // int4 loads where aligned
constexpr int TILE = THREADS * PER;    // nodes a block holds at once
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool aligned16(const int32_t* p)
{
    return ((uintptr_t)p & 15u) == 0;
}

// row[n .. n + PER), *fill* at nodes >= N
__device__ __forceinline__ void load_row(
    const int32_t* row, bool vec, int n, int N, int fill, int (&v)[PER])
{
    if constexpr (VECTOR && PER % 4 == 0) {
        if (vec && n + PER <= N) {
#pragma unroll
            for (int j = 0; j < PER; j += 4) {
                const int4 q = *reinterpret_cast<const int4*>(row + n + j);
                v[j] = q.x;
                v[j + 1] = q.y;
                v[j + 2] = q.z;
                v[j + 3] = q.w;
            }
            return;
        }
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) v[j] = n + j < N ? row[n + j] : fill;
}

__device__ __forceinline__ int capw_of(int e, int c, int t, int fair)
{
    return e == t ? min(max(c, 1), fair) : 0;
}

__global__ void __launch_bounds__(THREADS) spec_fill_kernel(
    int32_t* __restrict__ plan,    // [7, N]
    int32_t* __restrict__ status,  // [TT + 1]
    const int32_t* __restrict__ gate,  // [1]: 0 = a dead megaround iteration
    int N)
{
    const int open = *gate;  // 0: nothing reaches device memory
    __shared__ int s_win[WARPS];
    __shared__ int s_hi[WARPS];
    __shared__ int2 s_scan[2][WARPS];
    const int t = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int32_t* elect = plan;
    const int32_t* hi = plan + (size_t)N;
    const int32_t* cap = plan + 2 * (size_t)N;
    int32_t* count = plan + 6 * (size_t)N;
    const bool v_elect = aligned16(elect), v_hi = aligned16(hi), v_cap = aligned16(cap);
    const int mine = threadIdx.x * PER;  // the thread's first node in a tile

    int e[PER], h[PER], c[PER];
    const int need = status[1 + t];
    load_row(elect, v_elect, mine, N, -1, e);
    load_row(hi, v_hi, mine, N, 0, h);
    load_row(cap, v_cap, mine, N, 0, c);
    if (!open || need <= 0) return;  // a dead iteration, or no node elected this row

    // the winner count: one barrier
    int wins = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) wins += e[j] == t;
    for (int n0 = TILE; n0 < N; n0 += TILE) {
        int more[PER];
        load_row(elect, v_elect, n0 + mine, N, -1, more);
#pragma unroll
        for (int j = 0; j < PER; ++j) wins += more[j] == t;
    }
    wins = __reduce_add_sync(FULL, wins);
    if (lane == 0) s_win[warp] = wins;
    __syncthreads();
    int n_win = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) n_win += s_win[w];
    if (n_win == 0) return;  // nothing taken, need unchanged
    const int fair = (need + n_win - 1) / n_win;

    // past one tile, the pref-2 total first: one more barrier
    int total_hi = 0;
    if (N > TILE) {
        int x = 0;
#pragma unroll
        for (int j = 0; j < PER; ++j) x += h[j] ? capw_of(e[j], c[j], t, fair) : 0;
        for (int n0 = TILE; n0 < N; n0 += TILE) {
            int ee[PER], hh[PER], cc[PER];
            load_row(elect, v_elect, n0 + mine, N, -1, ee);
            load_row(hi, v_hi, n0 + mine, N, 0, hh);
            load_row(cap, v_cap, n0 + mine, N, 0, cc);
#pragma unroll
            for (int j = 0; j < PER; ++j) x += hh[j] ? capw_of(ee[j], cc[j], t, fair) : 0;
        }
        x = __reduce_add_sync(FULL, x);
        if (lane == 0) s_hi[warp] = x;
        __syncthreads();
#pragma unroll
        for (int w = 0; w < WARPS; ++w) total_hi += s_hi[w];
    }

    // the fill, tile by tile: one scan of (hi, lo) pairs and one barrier a tile
    int carry_hi = 0, carry_lo = 0;
    for (int n0 = 0, k = 0; n0 < N; n0 += TILE, ++k) {
        if (k > 0) {
            load_row(elect, v_elect, n0 + mine, N, -1, e);
            load_row(hi, v_hi, n0 + mine, N, 0, h);
            load_row(cap, v_cap, n0 + mine, N, 0, c);
        }
        int x = 0, y = 0;  // the thread's capw sums, pref 2 and pref 1
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            const int capw = capw_of(e[j], c[j], t, fair);
            if (h[j]) x += capw; else y += capw;
        }
        int2 incl = make_int2(x, y);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int xo = __shfl_up_sync(FULL, incl.x, o);
            const int yo = __shfl_up_sync(FULL, incl.y, o);
            if (lane >= o) {
                incl.x += xo;
                incl.y += yo;
            }
        }
        int2* pairs = s_scan[k & 1];
        if (lane == 31) pairs[warp] = incl;
        __syncthreads();
        int2 before = make_int2(0, 0), tile = make_int2(0, 0);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const int2 p = pairs[w];
            if (w < warp) {
                before.x += p.x;
                before.y += p.y;
            }
            tile.x += p.x;
            tile.y += p.y;
        }
        if (N <= TILE) total_hi = tile.x;
        // the exclusive prefixes of the thread's nodes, pref 2 and pref 1
        int at_hi = carry_hi + before.x + incl.x - x;
        int at_lo = total_hi + carry_lo + before.y + incl.y - y;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            const int capw = capw_of(e[j], c[j], t, fair);
            if (e[j] == t) count[n0 + mine + j] = min(max(need - (h[j] ? at_hi : at_lo), 0), capw);
            if (h[j]) at_hi += capw; else at_lo += capw;
        }
        carry_hi += tile.x;
        carry_lo += tile.y;
    }
    if (threadIdx.x == 0) {
        const int taken = min(need, carry_hi + carry_lo);  // the takes telescope
        status[1 + t] = need - taken;
        if (taken > 0) status[0] = 1;
    }
}

}  // namespace

extern "C" int nhd_spec_fill(
    void* plan, void* status, const void* gate, int TT, int N, int device,
    void* stream)
{
    if (TT < 0 || N < 0 || N > INT_MAX - TILE) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (TT == 0 || N == 0) return 0;
    spec_fill_kernel<<<(unsigned)TT, THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)plan, (int32_t*)status, (const int32_t*)gate, N);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_spec_fill_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
