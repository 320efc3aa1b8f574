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
// gives a negative index.
//
// Bound: bytes. Each thread reads a handful of small per-node rows that
// stay in L1/L2 and writes two bytes; the N x C*A byte outputs dominate
// the traffic. One thread per output element, no shared memory: a simple
// kernel that is right first.

#include <cuda_runtime.h>
#include <stdint.h>

#define NHD_MAX_G 16

__global__ void nic_node_masks_kernel(
    const int32_t* __restrict__ nic_count,    // [N, U]
    const int32_t* __restrict__ nic_sw,       // [N, U, K]
    const int32_t* __restrict__ gpu_free_sw,  // [N, S]
    const int32_t* __restrict__ combo,        // [C, G]
    const int32_t* __restrict__ pick,         // [A, G]
    const int32_t* __restrict__ need_max,     // [C, A, U] == [C*A, U]
    uint8_t* __restrict__ valid,              // [N, C*A]
    uint8_t* __restrict__ pci_ok,             // [N, C*A]
    int N, int U, int K, int S, int G, int C, int A)
{
    const long long CA = (long long)C * A;
    const long long total = (long long)N * CA;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const int n = (int)(i / CA);
        const int ca = (int)(i - (long long)n * CA);
        const int c = ca / A;
        const int a = ca - c * A;

        const int32_t* need = need_max + (long long)ca * U;
        const int32_t* cnt = nic_count + (long long)n * U;
        bool v = true;
        for (int u = 0; u < U; ++u) v = v && (need[u] <= cnt[u]);

        const int32_t* free_sw = gpu_free_sw + (long long)n * S;
        bool ok = true;
        for (int s = 0; s < S; ++s) ok = ok && (free_sw[s] >= 0);

        int sw[NHD_MAX_G];
        for (int g = 0; g < G; ++g) {
            const int u = combo[c * G + g];
            const int k = pick[a * G + g];
            sw[g] = nic_sw[((long long)n * U + u) * K + k];
        }
        for (int g = 0; g < G && ok; ++g) {
            int share = 0;
            for (int h = 0; h < G; ++h) share += (sw[h] == sw[g]);
            const int idx = sw[g] < 0 ? sw[g] + S : sw[g];
            ok = idx >= 0 && idx < S && share <= free_sw[idx];
        }
        valid[i] = v ? 1 : 0;
        pci_ok[i] = ok ? 1 : 0;
    }
}

extern "C" int nhd_nic_node_masks(
    const void* nic_count, const void* nic_sw, const void* gpu_free_sw,
    const void* combo, const void* pick, const void* need_max,
    void* valid, void* pci_ok,
    int N, int U, int K, int S, int G, int C, int A,
    int device, void* stream)
{
    if (G > NHD_MAX_G) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)N * C * A;
    if (total == 0) return 0;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 2147483647LL) blocks = 2147483647LL;
    nic_node_masks_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nic_count, (const int32_t*)nic_sw,
        (const int32_t*)gpu_free_sw, (const int32_t*)combo,
        (const int32_t*)pick, (const int32_t*)need_max,
        (uint8_t*)valid, (uint8_t*)pci_ok, N, U, K, S, G, C, A);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_nic_node_masks_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
