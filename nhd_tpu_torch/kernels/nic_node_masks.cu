// nic_node_masks: the node-only inputs of the NIC stage, for Hopper (sm_90a).
//
// Replaces the pick-validity and PCI-switch masks of the reference solve
// (nhd_tpu/solver/kernel.py:136-160, an XLA fusion inside _solve): for every
// node n and (combo c, NIC pick a) slot ca = c*A + a
//   valid[n, ca]  = all_u  need_max[c, a, u] <= nic_count[n, u]
//   pci_ok[n, ca] = all_g  share(g) <= gpu_free_sw[n, sw(g)]  and  all_s gpu_free_sw[n, s] >= 0
// where sw(g) is the switch of the NIC slot group g chose and share(g) the
// number of groups whose slot sits on that switch. A switch id of -1 (no
// NIC) indexes the last switch, the wrap the reference's take_along_axis
// gives a negative index; an id outside [-S, S) makes the check false.
//
// Bound: bytes. The N x C*A byte outputs are all the traffic there is; the
// per-node rows are a few hundred bytes a node. The design keeps every
// per-node and per-slot quantity out of the per-element work:
//   * a block owns a strip of NB nodes and stages their nic_count, nic_sw
//     and gpu_free_sw rows in shared memory once; the "every switch >= 0"
//     bit is computed once per node there;
//   * a thread owns one ca (lanes across ca) and keeps that ca's G slot
//     indices u*K + k and its need row in registers, then walks the
//     strip's nodes, so a slot is looked up once per thread, not per node;
//   * where C*A is smaller than the block, the block's threads cover
//     several nodes at once ((node, ca) packed across lanes), so small
//     buckets still use whole warps;
//   * index math is 32-bit (one division per thread, none per element),
//     and neighbouring lanes write neighbouring bytes of one node row.
// A node row past 48 KB of shared memory (U*K in the thousands) is read
// from global memory through the same pointer instead of being staged.

// Gate: *gate* is one int32 word of the megaround's control tensor (the
// bucket's live flag, written by spec_gate.cu). Where it is 0 every block
// returns before it writes device memory: a dead iteration of the
// fixed-trip megaround, or a bucket with no need left. Its load issues
// beside the kernel's first loads and is tested after them, so a live
// launch waits for no extra round trip. Outside the megaround it is a
// word that is always 1.

#include <cuda_runtime.h>
#include <stdint.h>

#define NHD_MAX_G 16

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 48 * 1024;
constexpr int MAX_U_REGS = 4;
// the grid grows to about this many blocks before a block takes more nodes
// (512 against 2048: 0.0084 against 0.0089 ms at the cfg4 G=2 bucket,
// where a block then takes 2 nodes instead of 1; equal at the others)
constexpr long long GRID_TARGET = 512;

template <int MAXG>
__global__ void __launch_bounds__(THREADS) nic_node_masks_kernel(
    const int32_t* __restrict__ nic_count,    // [N, U]
    const int32_t* __restrict__ nic_sw,       // [N, U, K]
    const int32_t* __restrict__ gpu_free_sw,  // [N, S]
    const int32_t* __restrict__ combo,        // [C, G]
    const int32_t* __restrict__ pick,         // [A, G]
    const int32_t* __restrict__ need_max,     // [C, A, U] == [C*A, U]
    const int32_t* __restrict__ gate,         // [1]: 0 = a dead megaround bucket
    uint8_t* __restrict__ valid,              // [N, C*A]
    uint8_t* __restrict__ pci_ok,             // [N, C*A]
    int N, int U, int K, int S, int G, int C, int A,
    int ca_chunk, int nodes_per_pass, int nodes_per_block, int staged)
{
    const int open = *gate;  // 0: nothing reaches device memory
    extern __shared__ int32_t smem[];
    const int CA = C * A;
    const int UK = U * K;
    const int NB = nodes_per_block;
    const int n0 = blockIdx.x * NB;
    const int nb = min(NB, N - n0);

    int32_t* s_cnt = smem;              // [NB, U]
    int32_t* s_fsw = s_cnt + NB * U;    // [NB, S]
    int32_t* s_ok = s_fsw + NB * S;     // [NB]
    int32_t* s_sw = s_ok + NB;          // [NB, UK] when staged
    {
        const int32_t* cnt_rows = nic_count + (size_t)n0 * U;
        const int32_t* fsw_rows = gpu_free_sw + (size_t)n0 * S;
        for (int i = threadIdx.x; i < nb * U; i += blockDim.x) s_cnt[i] = cnt_rows[i];
        for (int i = threadIdx.x; i < nb * S; i += blockDim.x) s_fsw[i] = fsw_rows[i];
        if (staged) {
            const int32_t* sw_rows = nic_sw + (size_t)n0 * UK;
            for (int i = threadIdx.x; i < nb * UK; i += blockDim.x) s_sw[i] = sw_rows[i];
        }
    }
    __syncthreads();
    if (!open) return;  // the whole block: the gate's load beside the staging's
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
        bool ok = true;
        for (int s = 0; s < S; ++s) ok = ok && (s_fsw[j * S + s] >= 0);
        s_ok[j] = ok ? 1 : 0;
    }
    __syncthreads();
    const int32_t* sw_base = staged ? s_sw : nic_sw + (size_t)n0 * UK;

    const int j0 = threadIdx.x / ca_chunk;
    const int ca = blockIdx.y * ca_chunk + (threadIdx.x - j0 * ca_chunk);
    if (j0 >= nodes_per_pass || ca >= CA) return;
    const int c = ca / A;
    const int a = ca - c * A;

    int slot[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
        slot[g] = g < G ? combo[c * G + g] * K + pick[a * G + g] : 0;
    const int32_t* need = need_max + (size_t)ca * U;
    int need_r[MAX_U_REGS];
#pragma unroll
    for (int u = 0; u < MAX_U_REGS; ++u) need_r[u] = u < U ? need[u] : 0;

    for (int j = j0; j < nb; j += nodes_per_pass) {
        const int32_t* cnt = s_cnt + j * U;
        bool v = true;
#pragma unroll
        for (int u = 0; u < MAX_U_REGS; ++u)
            if (u < U) v = v && (need_r[u] <= cnt[u]);
        for (int u = MAX_U_REGS; u < U; ++u) v = v && (need[u] <= cnt[u]);

        const int32_t* swr = sw_base + (size_t)j * UK;
        const int32_t* fsw = s_fsw + j * S;
        int sw[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) sw[g] = g < G ? swr[slot[g]] : 0;
        bool ok = s_ok[j] != 0;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            if (g < G && ok) {
                int share = 0;
#pragma unroll
                for (int h = 0; h < MAXG; ++h) share += (h < G && sw[h] == sw[g]);
                const int idx = sw[g] < 0 ? sw[g] + S : sw[g];
                ok = idx >= 0 && idx < S && share <= fsw[idx];
            }
        }
        const size_t o = (size_t)(n0 + j) * CA + ca;
        valid[o] = v ? 1 : 0;
        pci_ok[o] = ok ? 1 : 0;
    }
}

}  // namespace

extern "C" int nhd_nic_node_masks(
    const void* nic_count, const void* nic_sw, const void* gpu_free_sw,
    const void* combo, const void* pick, const void* need_max,
    const void* gate, void* valid, void* pci_ok,
    int N, int U, int K, int S, int G, int C, int A,
    int device, void* stream)
{
    if (G < 1 || G > NHD_MAX_G || U < 1 || K < 1 || S < 1)
        return (int)cudaErrorInvalidValue;
    const long long CA = (long long)C * A;
    if (CA > 2147483647LL || (long long)N * U * K > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (N == 0 || CA == 0) return 0;

    // lanes across ca; a chunk of the ca axis per block row, several nodes
    // per pass where the whole axis fits in fewer lanes than the block has
    const int ca_chunk = CA < THREADS ? (int)CA : THREADS;
    const int per_pass = THREADS / ca_chunk;
    const long long chunks = (CA + ca_chunk - 1) / ca_chunk;
    if (chunks > 65535) return (int)cudaErrorInvalidValue;
    // passes per block: the fewest that keep the grid near GRID_TARGET blocks
    int passes = 1;
    while (passes < 32 &&
           chunks * (((long long)N + per_pass * passes - 1) / (per_pass * passes)) > GRID_TARGET)
        passes *= 2;
    int NB = per_pass * passes;
    const long long row_bytes = 4LL * (U + S + 1);
    const long long sw_bytes = 4LL * U * K;
    // fewer nodes a block where their rows would not fit shared memory; a
    // single node row that does not fit reads its switch ids from global
    while (NB > 1 && (long long)NB * (row_bytes + sw_bytes) > SMEM_LIMIT) NB /= 2;
    const int staged = (long long)NB * (row_bytes + sw_bytes) <= SMEM_LIMIT;
    if ((long long)NB * row_bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)NB * (row_bytes + (staged ? sw_bytes : 0));
    const dim3 grid((unsigned)((N + NB - 1) / NB), (unsigned)chunks);
    if (G <= 4) {
        nic_node_masks_kernel<4><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const int32_t*)nic_count, (const int32_t*)nic_sw,
            (const int32_t*)gpu_free_sw, (const int32_t*)combo,
            (const int32_t*)pick, (const int32_t*)need_max,
            (const int32_t*)gate, (uint8_t*)valid, (uint8_t*)pci_ok, N, U, K, S, G, C, A,
            ca_chunk, per_pass, NB, staged);
    } else {
        nic_node_masks_kernel<NHD_MAX_G><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const int32_t*)nic_count, (const int32_t*)nic_sw,
            (const int32_t*)gpu_free_sw, (const int32_t*)combo,
            (const int32_t*)pick, (const int32_t*)need_max,
            (const int32_t*)gate, (uint8_t*)valid, (uint8_t*)pci_ok, N, U, K, S, G, C, A,
            ca_chunk, per_pass, NB, staged);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_nic_node_masks_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
