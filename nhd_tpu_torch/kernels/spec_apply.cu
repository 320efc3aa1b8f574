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
//   claims[row, n] = t * 2^21 + (c * U + m) * A_t + a,  counts[row, n] = k,
// with row = *step - 1: the iteration count spec_gate keeps in the
// megaround's control tensor (ctl[1]), so one captured body serves every
// pass of the graph's WHILE node; the host loop passes the word of
// arange(1, IT + 1) for its iteration.
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
// Bound: the launch at the main path's sizes, then a few dependent loads
// per claiming node. The design:
//   * a warp owns one node (WARPS nodes a block) and leaves at once when
//     the node took nothing, so a node that claims waits for no other;
//   * lanes go across the U*K NIC slots (32 a step), each lane holding its
//     slot's headroom, switch id and table entries in registers; lanes go
//     across u for the cpu and gpu rows and across s for the switches; one
//     lane writes hugepages, busy, the claim word and the count;
//   * sharing off: a free slot's running count among its NUMA node's free
//     slots (the reference's cumsum) is its rank in a ballot of the free
//     slots, masked to its segment and the lanes below it, plus the free
//     slots of the same segment in earlier steps; the slot is zeroed when
//     that count, as float32, is <= k * nic_occ, as the reference compares;
//   * switch deltas: one pass over the slots adds k * gpu_uk into the
//     warp's [S] accumulators in shared memory, then lanes across s apply
//     them. The sum runs in another order than the reference's einsum,
//     which is exact only because every gpu_uk entry is an integer and
//     every per-switch sum k * gpu_uk stays below 2^24, so every partial
//     sum is an integer float32 holds exactly. On the main path that holds
//     by construction: spec_tables (solver/speculate.py) writes gpu_uk =
//     gpu_dem * map_pci, nonzero only on a row with FLAG_MAP_PCI, and
//     spec_elect caps such a row at one copy, so k <= 1 wherever gpu_uk is
//     not 0 and a switch's sum is one pod's GPU count. A change to that
//     single-copy rule must keep the sums below 2^24
//     (tests/test_torch_sweep.py holds the premise on the sweep cases and
//     on cfg4's tables, and the FLAG_MAP_PCI rule on the latter);
//   * index math is 32-bit (Idx), the launcher refusing a buffer of 2^31
//     elements or more: 64-bit offsets timed up to 0.0002 ms slower at
//     cfg4's and cfg3's shapes on an H100 (kernel_variants.py, idx64).

// Gate: *gate* is one int32 word of the megaround's control tensor (its
// alive flag, written by spec_gate.cu). Where it is 0 every block returns
// before it writes device memory: a dead iteration of the launch-by-launch
// trip. Its load, and the step's, issue beside the kernel's first loads
// and are tested after them, so a live launch waits for no extra round
// trip. Outside the megaround it is a word that is always 1. A step
// outside [1, IT] writes nothing either (spec_gate's cap keeps it inside).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // nodes (warps) a block, at most
constexpr int THREADS = 32 * WARPS;
constexpr int SMEM_LIMIT = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int T_SHIFT = 21;
using Idx = int;  // offsets into every buffer

// lanes [lo, hi) of a warp, clipped to [0, 32)
__device__ __forceinline__ unsigned lane_range(int lo, int hi)
{
    lo = max(lo, 0);
    hi = min(hi, 32);
    if (lo >= hi) return 0u;
    const unsigned below_hi = hi == 32 ? FULL : (1u << hi) - 1u;
    return below_hi & ~((1u << lo) - 1u);
}

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
    const int32_t* __restrict__ step,      // [1]: the iteration, 1-based
    const int32_t* __restrict__ gate,      // [1]: 0 = a dead megaround iteration
    int TT, int N, int U, int K, int S, int CM, int CAM, int IT,
    int sharing, int respect_busy)
{
    const int open = *gate;  // 0: nothing reaches device memory
    const int it = *step - 1;  // the claim row
    extern __shared__ float s_delta_all[];  // [warps a block, S]
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n = blockIdx.x * (blockDim.x >> 5) + warp;
    if (n >= N) return;  // the whole warp
    const Idx row = (Idx)N;
    // the plan entries together (one broadcast load each), then leave
    // unless the node took copies
    const int t = plan[n];
    const int c = plan[3 * row + n];
    const int m = plan[4 * row + n];
    const int a = plan[5 * row + n];
    const int k = plan[6 * row + n];
    const bool smt_n = smt[n];
    if (!open || it < 0 || it >= IT || t < 0 || k <= 0)
        return;  // a dead iteration, or no copies

    const int A_t = trow[4 * t], C_t = trow[4 * t + 1], hp_t = trow[4 * t + 3];
    const int cb = min(max(c, 0), C_t - 1);
    const int mb = min(max(m, 0), U - 1);
    const int ab = min(max(a, 0), A_t - 1);
    const int ca = cb * A_t + ab;
    const int s = smt_n ? 0 : 1;
    const int UK = U * K;
    const float kf = (float)k;

    // cpu and gpu: lanes across u
    const float* g_row = cpu_g + (((Idx)s * TT + t) * CM + cb) * U;
    const float* m_row = cpu_m + (((Idx)s * TT + t) * U + mb) * U;
    const float* gg_row = gpu_g + ((Idx)t * CM + cb) * U;
    for (int u = lane; u < U; u += 32) {
        const Idx nu = (Idx)n * U + u;
        const float dem = __fadd_rn(g_row[u], m_row[u]);
        cpu_free[nu] = __float2int_rz(__fsub_rn((float)cpu_free[nu], __fmul_rn(kf, dem)));
        gpu_free[nu] = __float2int_rz(__fsub_rn((float)gpu_free[nu], __fmul_rn(kf, gg_row[u])));
    }

    // NICs: lanes across the slots
    float* nf = nic_free + (Idx)n * UK * 2;
    const Idx slot_row = ((Idx)t * CAM + ca) * UK;
    if (sharing) {
        for (int i = lane; i < UK; i += 32) {
            nf[2 * i] = __fsub_rn(nf[2 * i], __fmul_rn(kf, nic_rx[slot_row + i]));
            nf[2 * i + 1] = __fsub_rn(nf[2 * i + 1], __fmul_rn(kf, nic_tx[slot_row + i]));
        }
    } else {
        const float* occ_row = nic_occ + ((Idx)t * CAM + ca) * U;
        const unsigned upto_me = lane == 31 ? FULL : (2u << lane) - 1u;
        int carry = 0;  // free slots of the segment open at c0, in earlier steps
        for (int c0 = 0; c0 < UK; c0 += 32) {
            const int slot = c0 + lane;
            const bool fr = slot < UK && nf[2 * slot] > 0.0f;
            const unsigned bal = __ballot_sync(FULL, fr);
            if (fr) {
                const int u = slot / K;
                const int lo = u * K - c0;  // my segment's first lane (< 0: earlier step)
                const int seen = __popc(bal & lane_range(lo, lo + K) & upto_me)
                    + (lo < 0 ? carry : 0);
                if ((float)seen <= __fmul_rn(kf, occ_row[u])) {
                    nf[2 * slot] = 0.0f;
                    nf[2 * slot + 1] = 0.0f;
                }
            }
            // the segment open at the next step's first slot, counted so far
            const int lo = ((c0 + 32) / K) * K - c0;
            carry = (lo < 0 ? carry : 0) + __popc(bal & lane_range(lo, 32));
        }
    }

    // switches: one pass over the slots into the warp's accumulators
    float* s_delta = s_delta_all + warp * S;
    for (int sw = lane; sw < S; sw += 32) s_delta[sw] = 0.0f;
    __syncwarp();
    const int32_t* sw_row = nic_sw + (Idx)n * UK;
    for (int i = lane; i < UK; i += 32) {
        const int sw = sw_row[i];
        const float d = __fmul_rn(kf, gpu_uk[slot_row + i]);
        if (sw >= 0 && sw < S && d != 0.0f) atomicAdd(&s_delta[sw], d);
    }
    __syncwarp();
    for (int sw = lane; sw < S; sw += 32) {
        const Idx ns = (Idx)n * S + sw;
        gpu_free_sw[ns] = __float2int_rz(__fsub_rn((float)gpu_free_sw[ns], s_delta[sw]));
    }

    if (lane == 0) {
        hp_free[n] -= __float2int_rz(__fmul_rn(kf, (float)hp_t));
        if (respect_busy) busy[n] = true;
        claims[(Idx)it * N + n] = t * (1 << T_SHIFT) + (c * U + m) * A_t + a;
        counts[(Idx)it * N + n] = k;
    }
}

}  // namespace

extern "C" int nhd_spec_apply(
    const void* plan, const void* trow, const void* smt, const void* nic_sw,
    const void* cpu_g, const void* cpu_m, const void* gpu_g, const void* nic_occ,
    const void* gpu_uk, const void* nic_rx, const void* nic_tx,
    void* busy, void* hp_free, void* cpu_free, void* gpu_free, void* nic_free,
    void* gpu_free_sw, void* claims, void* counts, const void* step,
    const void* gate, int TT, int N, int U, int K, int S, int CM, int CAM,
    int IT, int SHARING, int BUSY, int device, void* stream)
{
    if (TT < 1 || U < 1 || K < 1 || S < 1 || CM < 1 || CAM < 1 || IT < 1)
        return (int)cudaErrorInvalidValue;
    // a warp's switch accumulators in 48 KB of shared memory: fewer warps a
    // block for a wide switch row
    int warps = WARPS;
    while (warps > 1 && (size_t)warps * S * sizeof(float) > (size_t)SMEM_LIMIT) warps /= 2;
    if ((size_t)warps * S * sizeof(float) > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (N == 0) return 0;
    const long long lengths[] = {7LL * N, 2LL * N * U * K, (long long)N * S,
                                 (long long)IT * N, 2LL * TT * CM * U,
                                 2LL * TT * U * U, (long long)TT * CAM * U * K};
    for (long long v : lengths)
        if (v > 2147483647LL) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((N + warps - 1) / warps);
    const size_t smem = (size_t)warps * S * sizeof(float);
    spec_apply_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
        (const int32_t*)plan, (const int32_t*)trow, (const bool*)smt,
        (const int32_t*)nic_sw, (const float*)cpu_g, (const float*)cpu_m,
        (const float*)gpu_g, (const float*)nic_occ, (const float*)gpu_uk,
        (const float*)nic_rx, (const float*)nic_tx, (bool*)busy,
        (int32_t*)hp_free, (int32_t*)cpu_free, (int32_t*)gpu_free,
        (float*)nic_free, (int32_t*)gpu_free_sw, (int32_t*)claims,
        (int32_t*)counts, (const int32_t*)step, (const int32_t*)gate, TT, N, U, K, S,
        CM, CAM, IT, SHARING, BUSY);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_spec_apply_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
