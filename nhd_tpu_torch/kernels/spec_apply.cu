// spec_apply: the megaround's claim deltas and claim record, for Hopper
// (sm_90a).
//
// Replaces the aggregate state update and the claim record of the
// speculative megaround's loop body (nhd_tpu/solver/speculate.py:448-527).
// For every node n that took k = count > 0 copies of its elected type t at
// (c, m, a), with the demand rows of the hoisted tables at (t, c, m, a):
//   cpu_free[n, u] = int(f32(cpu_free) - k * (cpu_g + cpu_m))   (SMT or raw)
//   gpu_free[n, u] = int(f32(gpu_free) - k * gpu_g)
//   hp_free[n]    -= int(k * hp)
//   sharing on:  nic_free[n, u, k', rx|tx] -= k * nic_rx|nic_tx[t, ca, u*K+k']
//   sharing off: the lowest-indexed free NICs of each NUMA node u, as many
//                as k * nic_occ[t, ca, u], are zeroed (rx and tx)
//   gpu_free_sw[n, s] = int(f32(gpu_free_sw) - sum over slots on switch s
//                       of k * gpu_uk[t, ca, slot])
//   busy[n] = 1 when respect_busy
//   claims[it, n] = t * 2^21 + (c * U + m) * A_t + a,  counts[it, n] = k.
// Nodes that took nothing keep their state, their claim word -1 and their
// count 0 (the dispatch fills those planes once). Every float step is the
// reference's float32 arithmetic, rounded as XLA rounds it (the products
// and differences are written with _rn intrinsics so nvcc cannot contract
// them into a fused multiply-add), then a truncating cast back.
//
// The kernel updates the caller's resident node tensors in place: the
// reference donated them to its jitted loop (nhd_tpu/solver/
// device_state.py:539-565), and the next iteration's solve must read the
// projected state.
//
// Bound: the launch at the main path's sizes; one thread per node touches
// its own rows only (a few hundred bytes) when it took copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int T_SHIFT = 21;

__global__ void __launch_bounds__(THREADS) spec_apply_kernel(
    const int32_t* __restrict__ plan,      // [7, N]
    const int32_t* __restrict__ trow,      // [TT, 4]: A, C, flags, hp
    const bool* __restrict__ smt,          // [N]
    const int32_t* __restrict__ nic_sw,    // [N, U, K]
    const float* __restrict__ cpu_g,       // [2, TT, CM, U]
    const float* __restrict__ cpu_m,       // [2, TT, U, U]
    const float* __restrict__ gpu_g,       // [TT, CM, U]
    const float* __restrict__ nic_occ,     // [TT, CAM, U]
    const float* __restrict__ gpu_uk,      // [TT, CAM, U*K]
    const float* __restrict__ nic_rx,      // [TT, CAM, U*K]
    const float* __restrict__ nic_tx,      // [TT, CAM, U*K]
    bool* __restrict__ busy,               // [N]
    int32_t* __restrict__ hp_free,         // [N]
    int32_t* __restrict__ cpu_free,        // [N, U]
    int32_t* __restrict__ gpu_free,        // [N, U]
    float* __restrict__ nic_free,          // [N, U, K, 2]
    int32_t* __restrict__ gpu_free_sw,     // [N, S]
    int32_t* __restrict__ claims,          // [IT, N]
    int32_t* __restrict__ counts,          // [IT, N]
    int TT, int N, int U, int K, int S, int CM, int CAM, int it,
    int sharing, int respect_busy)
{
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const size_t row = (size_t)N;
    const int t = plan[n];
    const int k = plan[6 * row + n];
    if (t < 0 || k <= 0) return;
    const int c = plan[3 * row + n];
    const int m = plan[4 * row + n];
    const int a = plan[5 * row + n];
    const int A_t = trow[4 * t], C_t = trow[4 * t + 1], hp_t = trow[4 * t + 3];
    const int cb = min(max(c, 0), C_t - 1);
    const int mb = min(max(m, 0), U - 1);
    const int ab = min(max(a, 0), A_t - 1);
    const int ca = cb * A_t + ab;
    const int s = smt[n] ? 0 : 1;
    const int UK = U * K;
    const float kf = (float)k;

    const float* g_row = cpu_g + (((size_t)s * TT + t) * CM + cb) * U;
    const float* m_row = cpu_m + (((size_t)s * TT + t) * U + mb) * U;
    const float* gg_row = gpu_g + ((size_t)t * CM + cb) * U;
    const float* occ_row = nic_occ + ((size_t)t * CAM + ca) * U;
    for (int u = 0; u < U; ++u) {
        const size_t nu = (size_t)n * U + u;
        const float dem = __fadd_rn(g_row[u], m_row[u]);
        cpu_free[nu] = __float2int_rz(__fsub_rn((float)cpu_free[nu], __fmul_rn(kf, dem)));
        gpu_free[nu] = __float2int_rz(__fsub_rn((float)gpu_free[nu], __fmul_rn(kf, gg_row[u])));
    }
    hp_free[n] -= __float2int_rz(__fmul_rn(kf, (float)hp_t));

    float* nf = nic_free + (size_t)n * UK * 2;
    const size_t slot_row = ((size_t)t * CAM + ca) * UK;
    if (sharing) {
        for (int i = 0; i < UK; ++i) {
            nf[2 * i] = __fsub_rn(nf[2 * i], __fmul_rn(kf, nic_rx[slot_row + i]));
            nf[2 * i + 1] = __fsub_rn(nf[2 * i + 1], __fmul_rn(kf, nic_tx[slot_row + i]));
        }
    } else {
        for (int u = 0; u < U; ++u) {
            const float consume = __fmul_rn(kf, occ_row[u]);
            int seen = 0;
            for (int kk = 0; kk < K; ++kk) {
                float* p = nf + ((size_t)u * K + kk) * 2;
                if (p[0] > 0.0f) {
                    ++seen;
                    if ((float)seen <= consume) { p[0] = 0.0f; p[1] = 0.0f; }
                }
            }
        }
    }

    const int32_t* sw_row = nic_sw + (size_t)n * UK;
    const float* uk_row = gpu_uk + slot_row;
    for (int sw = 0; sw < S; ++sw) {
        float delta = 0.0f;
        for (int i = 0; i < UK; ++i)
            if (sw_row[i] == sw) delta = __fadd_rn(delta, __fmul_rn(kf, uk_row[i]));
        const size_t ns = (size_t)n * S + sw;
        gpu_free_sw[ns] = __float2int_rz(__fsub_rn((float)gpu_free_sw[ns], delta));
    }
    if (respect_busy) busy[n] = true;
    claims[(size_t)it * N + n] = t * (1 << T_SHIFT) + (c * U + m) * A_t + a;
    counts[(size_t)it * N + n] = k;
}

}  // namespace

extern "C" int nhd_spec_apply(
    const void* plan, const void* trow, const void* smt, const void* nic_sw,
    const void* cpu_g, const void* cpu_m, const void* gpu_g, const void* nic_occ,
    const void* gpu_uk, const void* nic_rx, const void* nic_tx,
    void* busy, void* hp_free, void* cpu_free, void* gpu_free, void* nic_free,
    void* gpu_free_sw, void* claims, void* counts,
    int TT, int N, int U, int K, int S, int CM, int CAM, int IT, int it,
    int SHARING, int BUSY, int device, void* stream)
{
    if (TT < 1 || U < 1 || K < 1 || S < 1 || CM < 1 || CAM < 1 || it < 0 || it >= IT)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (N == 0) return 0;
    const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
    spec_apply_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)plan, (const int32_t*)trow, (const bool*)smt,
        (const int32_t*)nic_sw, (const float*)cpu_g, (const float*)cpu_m,
        (const float*)gpu_g, (const float*)nic_occ, (const float*)gpu_uk,
        (const float*)nic_rx, (const float*)nic_tx, (bool*)busy,
        (int32_t*)hp_free, (int32_t*)cpu_free, (int32_t*)gpu_free,
        (float*)nic_free, (int32_t*)gpu_free_sw, (int32_t*)claims,
        (int32_t*)counts, TT, N, U, K, S, CM, CAM, it, SHARING, BUSY);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_spec_apply_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
