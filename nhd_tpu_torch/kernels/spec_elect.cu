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
// cap, c, m, a, count = 0 for spec_fill to fill); status[0], the progress
// flag, is cleared for spec_fill.
//
// Bound: bytes, and at the main path's sizes the launch. One thread per
// node reads its 2 plane words per type row (coalesced across the warp),
// then a few hundred bytes of table rows at its elected type. Division is
// IEEE (no fast math in the build): the floor of a quotient must match
// XLA's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float INF_CAP = 1048576.0f;  // 2^20
constexpr int FLAG_NEEDS_GPU = 1, FLAG_MAP_PCI = 2, FLAG_HAS_NIC = 4;

__device__ __forceinline__ float div_cap(float free_v, float dem)
{
    return dem > 0.0f ? floorf(__fdiv_rn(free_v, fmaxf(dem, 1e-6f))) : INF_CAP;
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
    int32_t* __restrict__ plan,               // [7, N]
    int TT, int N, int U, int K, int CM, int CAM, int sharing, int respect_busy)
{
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n == 0) status[0] = 0;
    if (n >= N) return;
    const int32_t* need = status + 1;

    int best_key = -1, elect = 0;
    for (int t = 0; t < TT; ++t) {
        const int nt = need[t];
        if (nt <= 0) continue;
        const long long base = plane_off[2 * t] + n;
        const long long ps = plane_off[2 * t + 1];
        if (planes[base + ps] == 0) continue;            // cand
        const int key = planes[base + 2 * ps] * (1 << 24) + min(nt, 1 << 20);
        if (key > best_key) { best_key = key; elect = t; }
    }
    int32_t* out = plan + n;
    const size_t row = (size_t)N;
    if (best_key < 0) {
        out[0] = -1;
        for (int r = 1; r < 7; ++r) out[r * row] = 0;
        return;
    }
    const int t = elect;
    const long long base = plane_off[2 * t] + n;
    const long long ps = plane_off[2 * t + 1];
    const int pref = planes[base + 2 * ps];
    const int c = planes[base + 3 * ps];
    const int m = planes[base + 4 * ps];
    const int a = planes[base + 5 * ps];
    const int A_t = trow[4 * t], C_t = trow[4 * t + 1];
    const int flags = trow[4 * t + 2], hp_t = trow[4 * t + 3];
    const int cb = min(max(c, 0), C_t - 1);
    const int mb = min(max(m, 0), U - 1);
    const int ab = min(max(a, 0), A_t - 1);
    const int ca = cb * A_t + ab;
    const int s = smt[n] ? 0 : 1;

    const float* g_row = cpu_g + (((size_t)s * TT + t) * CM + cb) * U;
    const float* m_row = cpu_m + (((size_t)s * TT + t) * U + mb) * U;
    const float* gg_row = gpu_g + ((size_t)t * CM + cb) * U;
    const float* occ_row = nic_occ + ((size_t)t * CAM + ca) * U;
    float cap_cpu = INF_CAP, cap_gpu = INF_CAP, cap_nic = INF_CAP;
    for (int u = 0; u < U; ++u) {
        const float dem = __fadd_rn(g_row[u], m_row[u]);
        cap_cpu = fminf(cap_cpu, div_cap((float)cpu_free[(size_t)n * U + u], dem));
        cap_gpu = fminf(cap_gpu, div_cap((float)gpu_free[(size_t)n * U + u], gg_row[u]));
        if (!sharing) {
            const float* nf = nic_free + ((size_t)n * U + u) * K * 2;
            int free_cnt = 0;
            for (int k = 0; k < K; ++k) free_cnt += nf[2 * k] > 0.0f;
            cap_nic = fminf(cap_nic, div_cap((float)free_cnt, occ_row[u]));
        }
    }
    float cap = fminf(cap_cpu, cap_gpu);
    if (!sharing) cap = fminf(cap, cap_nic);
    cap = fminf(cap, div_cap((float)hp_free[n], (float)hp_t));
    const bool one = (flags & FLAG_MAP_PCI)
        || (respect_busy && (flags & FLAG_NEEDS_GPU))
        || (sharing && (flags & FLAG_HAS_NIC));
    if (one) cap = fminf(cap, 1.0f);
    cap = fmaxf(cap, 0.0f);

    out[0] = t;
    out[row] = pref == 2 ? 1 : 0;
    out[2 * row] = (int)cap;
    out[3 * row] = c;
    out[4 * row] = m;
    out[5 * row] = a;
    out[6 * row] = 0;
}

}  // namespace

extern "C" int nhd_spec_elect(
    const void* planes, const void* plane_off, const void* trow, const void* smt,
    const void* cpu_free, const void* gpu_free, const void* hp_free,
    const void* nic_free, const void* cpu_g, const void* cpu_m,
    const void* gpu_g, const void* nic_occ, void* status, void* plan,
    int TT, int N, int U, int K, int CM, int CAM, int SHARING, int BUSY,
    int device, void* stream)
{
    if (TT < 1 || U < 1 || K < 1 || CM < 1 || CAM < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (N == 0) return 0;
    const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
    spec_elect_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)planes, (const long long*)plane_off, (const int32_t*)trow,
        (const bool*)smt, (const int32_t*)cpu_free, (const int32_t*)gpu_free,
        (const int32_t*)hp_free, (const float*)nic_free, (const float*)cpu_g,
        (const float*)cpu_m, (const float*)gpu_g, (const float*)nic_occ,
        (int32_t*)status, (int32_t*)plan, TT, N, U, K, CM, CAM, SHARING, BUSY);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_spec_elect_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
