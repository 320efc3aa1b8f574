// spec_elect: the megaround's per-node type election and copy capacity,
// for Hopper (sm_90a).
//
// Replaces, inside the speculative megaround's loop body
// (nhd_tpu/solver/speculate.py:301-404, an XLA program in a lax.while_loop),
// the election and the capacity projection. For every node n, over the
// global type rows t (every bucket's padded rows, bucket after bucket):
//   elig[t]  = cand[t, n] and need[t] > 0
//   key[t]   = elig ? pref[t, n] * 2^24 + min(need[t], 2^20) : -1
//   elect    = the first t of the largest key (jnp.argmax)
// then, at the elected (t, c, m, a), the per-NUMA demand rows from the
// hoisted tables and the float32 copy capacity
//   cap = min_u floor(free_u / max(dem_u, 1e-6))  over cpu, gpu, free NICs
//         (sharing off) and hugepages, INF = 2^20 where nothing is asked,
//   capped at 1 for single-copy types, floored at 0, cast to int32.
// The cand/pref/best_c/best_m/best_a planes are the solve's, read from the
// flat buffer the bucket solves wrote (plane_off gives each type row's base
// and plane stride). Output: the plan [7, N] (elect or -1, hi = pref 2,
// cap, c, m, a, count = 0 for spec_fill to fill); a node with no eligible
// row writes -1 and zeros. status[0], the progress flag, is cleared for
// spec_fill.
//
// Bound: bytes, and at the main path's sizes the launch and a chain of
// dependent loads. The design keeps that chain short and spreads it over
// the card:
//   * a warp owns one node (WARPS nodes a block: 256 blocks at 1024 nodes),
//     so the election runs on every SM, not on 8 of them. Four warps a
//     block timed 0.0001-0.0003 ms under eight at cfg4's and cfg3's shapes
//     on an H100 (kernel_variants.py, variant warps8);
//   * lanes go across the type rows (a lane takes t = lane, lane + 32, ...)
//     and read the per-type inputs (need, plane_off, trow) straight from
//     global memory, where every warp of an SM finds them in L1. Staging
//     them in shared memory first cost a block barrier: 0.0088 against
//     0.0082 ms on an H100 at cfg4's and cfg3's shapes (kernel_variants.py);
//   * each lane issues its cand, pref, best_c, best_m and best_a loads
//     together, with no branch in front of them, and keeps the (key, t, c,
//     m, a) of its first largest key; two warp reductions then give the
//     largest key and, among the lanes holding it, the lowest t, which is
//     the first maximum of jnp.argmax over the whole column, -1 keys
//     included;
//   * at the elected row, lanes go across u for the cpu, gpu and NIC-count
//     terms. The free NICs of NUMA node u are counted by a ballot over the
//     node's U*K rx headroom words, 32 slots a step, and a popcount of the
//     lanes of u's segment. The per-u capacities meet in a min reduction,
//     which does not depend on the order (no term is NaN);
//   * index math is 64-bit (Idx): 32-bit offsets timed no faster at
//     cfg4's and cfg3's shapes (variant idx32), so no size limit is needed.
// Division is IEEE (no fast math in the build): the floor of a quotient
// must match XLA's bit for bit. The key is computed in unsigned arithmetic,
// so a pref large enough to wrap wraps as int32 tensors do.

// Gate: *gate* is one int32 word of the megaround's control tensor (its
// alive flag, written by spec_gate.cu). Where it is 0 every block returns
// before it writes device memory: a dead iteration of the fixed-trip
// megaround. Its load issues beside the kernel's first loads and is
// tested after them, so a live launch waits for no extra round trip.
// Outside the megaround it is a word that is always 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                 // nodes (warps) a block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr float INF_CAP = 1048576.0f;  // 2^20
constexpr int FLAG_NEEDS_GPU = 1, FLAG_MAP_PCI = 2, FLAG_HAS_NIC = 4;
using Idx = long long;  // offsets into the node rows and the tables

__device__ __forceinline__ float div_cap(float free_v, float dem)
{
    return dem > 0.0f ? floorf(__fdiv_rn(free_v, fmaxf(dem, 1e-6f))) : INF_CAP;
}

// lanes [lo, hi) of a warp, clipped to [0, 32)
__device__ __forceinline__ unsigned lane_range(int lo, int hi)
{
    lo = max(lo, 0);
    hi = min(hi, 32);
    if (lo >= hi) return 0u;
    const unsigned below_hi = hi == 32 ? FULL : (1u << hi) - 1u;
    return below_hi & ~((1u << lo) - 1u);
}

__global__ void __launch_bounds__(THREADS) spec_elect_kernel(
    const int32_t* __restrict__ planes,
    const long long* __restrict__ plane_off,  // [TT, 2]: base, plane stride
    const int32_t* __restrict__ trow,         // [TT, 4]: A, C, flags, hp
    const bool* __restrict__ smt,             // [N]
    const int32_t* __restrict__ cpu_free,     // [N, U]
    const int32_t* __restrict__ gpu_free,     // [N, U]
    const int32_t* __restrict__ hp_free,      // [N]
    const float* __restrict__ nic_free,       // [N, U, K, 2]
    const float* __restrict__ cpu_g,          // [2, TT, CM, U]
    const float* __restrict__ cpu_m,          // [2, TT, U, U]
    const float* __restrict__ gpu_g,          // [TT, CM, U]
    const float* __restrict__ nic_occ,        // [TT, CAM, U]
    int32_t* __restrict__ status,             // [TT + 1]: progress, need
    const int32_t* __restrict__ gate,         // [1]: 0 = a dead megaround iteration
    int32_t* __restrict__ plan,               // [7, N]
    int TT, int N, int U, int K, int CM, int CAM, int sharing, int respect_busy)
{
    const int open = *gate;  // 0: nothing reaches device memory
    const int32_t* need = status + 1;
    const int lane = threadIdx.x & 31;
    const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (n >= N) return;  // the whole warp
    const bool smt_n = smt[n];
    const int hp_n = hp_free[n];
    if (!open) return;  // the gate's load beside the node's first two
    if (n == 0 && lane == 0) status[0] = 0;  // block 0's first thread

    // --- the election: lanes across type rows ---
    int best_key = INT32_MIN, best_t = INT32_MAX, best_pref = 0;
    int best_c = 0, best_m = 0, best_a = 0;
    bool any_elig = false;
    for (int t = lane; t < TT; t += 32) {
        const int nt = need[t];
        const long long at = plane_off[2 * t] + n, ps = plane_off[2 * t + 1];
        const int cand = planes[at + ps];
        const int pref = planes[at + 2 * ps];
        const int c = planes[at + 3 * ps];
        const int m = planes[at + 4 * ps];
        const int a = planes[at + 5 * ps];
        const bool elig = cand != 0 && nt > 0;
        const int key = elig
            ? (int)((unsigned)pref * (1u << 24) + (unsigned)min(nt, 1 << 20)) : -1;
        any_elig |= elig;
        if (key > best_key) {  // strict: a lane's first maximum
            best_key = key; best_t = t; best_pref = pref;
            best_c = c; best_m = m; best_a = a;
        }
    }
    const int top = __reduce_max_sync(FULL, best_key);
    const int t = __reduce_min_sync(FULL, best_key == top ? best_t : INT32_MAX);
    // the lane that read row t holds its planes (its own first maximum)
    const int owner = t & 31;
    const int pref = __shfl_sync(FULL, best_pref, owner);
    const int c = __shfl_sync(FULL, best_c, owner);
    const int m = __shfl_sync(FULL, best_m, owner);
    const int a = __shfl_sync(FULL, best_a, owner);
    int32_t* out = plan + n;
    const Idx row = (Idx)N;
    if (!__any_sync(FULL, any_elig)) {
        if (lane < 7) out[lane * row] = lane == 0 ? -1 : 0;
        return;
    }

    // --- the capacity at the elected (t, c, m, a): lanes across u ---
    const int A_t = trow[4 * t], C_t = trow[4 * t + 1];
    const int flags = trow[4 * t + 2], hp_t = trow[4 * t + 3];
    const int cb = min(max(c, 0), C_t - 1);
    const int mb = min(max(m, 0), U - 1);
    const int ab = min(max(a, 0), A_t - 1);
    const int ca = cb * A_t + ab;
    const int s = smt_n ? 0 : 1;
    const int UK = U * K;

    const float* g_row = cpu_g + (((Idx)s * TT + t) * CM + cb) * U;
    const float* m_row = cpu_m + (((Idx)s * TT + t) * U + mb) * U;
    const float* gg_row = gpu_g + ((Idx)t * CM + cb) * U;
    const float* occ_row = nic_occ + ((Idx)t * CAM + ca) * U;
    const float* nf = nic_free + (Idx)n * UK * 2;
    float cap = INF_CAP;
    for (int u0 = 0; u0 < U; u0 += 32) {
        const int u = u0 + lane;
        int free_cnt = 0;
        if (!sharing) {
            // the slots of NUMA nodes u0 .. u0 + 31, 32 a step; lane u
            // counts the free ones of its own segment [u*K, u*K + K)
            const int hi = min(U, u0 + 32) * K;
            for (int c0 = u0 * K; c0 < hi; c0 += 32) {
                const int slot = c0 + lane;
                const bool fr = slot < hi && nf[2 * slot] > 0.0f;
                const unsigned bal = __ballot_sync(FULL, fr);
                free_cnt += __popc(bal & lane_range(u * K - c0, u * K - c0 + K));
            }
        }
        if (u < U) {
            const Idx nu = (Idx)n * U + u;
            const float dem = __fadd_rn(g_row[u], m_row[u]);
            float cap_u = fminf(div_cap((float)cpu_free[nu], dem),
                                div_cap((float)gpu_free[nu], gg_row[u]));
            if (!sharing) cap_u = fminf(cap_u, div_cap((float)free_cnt, occ_row[u]));
            cap = fminf(cap, cap_u);
        }
    }
    for (int o = 16; o > 0; o >>= 1) cap = fminf(cap, __shfl_xor_sync(FULL, cap, o));
    cap = fminf(cap, div_cap((float)hp_n, (float)hp_t));
    const bool one = (flags & FLAG_MAP_PCI)
        || (respect_busy && (flags & FLAG_NEEDS_GPU))
        || (sharing && (flags & FLAG_HAS_NIC));
    if (one) cap = fminf(cap, 1.0f);
    cap = fmaxf(cap, 0.0f);

    if (lane < 7) {
        const int v = lane == 0 ? t : lane == 1 ? (pref == 2 ? 1 : 0)
            : lane == 2 ? (int)cap : lane == 3 ? c : lane == 4 ? m
            : lane == 5 ? a : 0;
        out[lane * row] = v;
    }
}

}  // namespace

extern "C" int nhd_spec_elect(
    const void* planes, const void* plane_off, const void* trow, const void* smt,
    const void* cpu_free, const void* gpu_free, const void* hp_free,
    const void* nic_free, const void* cpu_g, const void* cpu_m,
    const void* gpu_g, const void* nic_occ, void* status, const void* gate,
    void* plan,
    int TT, int N, int U, int K, int CM, int CAM, int SHARING, int BUSY,
    int device, void* stream)
{
    if (TT < 1 || U < 1 || K < 1 || CM < 1 || CAM < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (N == 0) return 0;
    const unsigned blocks = (unsigned)((N + WARPS - 1) / WARPS);
    spec_elect_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)planes, (const long long*)plane_off, (const int32_t*)trow,
        (const bool*)smt, (const int32_t*)cpu_free, (const int32_t*)gpu_free,
        (const int32_t*)hp_free, (const float*)nic_free, (const float*)cpu_g,
        (const float*)cpu_m, (const float*)gpu_g, (const float*)nic_occ,
        (int32_t*)status, (const int32_t*)gate, (int32_t*)plan, TT, N, U, K, CM, CAM, SHARING, BUSY);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_spec_elect_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
