// nic_any_first: the NIC feasibility stage of the solve, for Hopper (sm_90a).
//
// Replaces the repository's one Pallas kernel, attic/nic_pallas.py
// nic_any_first (pl.pallas_call at attic/nic_pallas.py:89), with the same
// inputs and outputs:
//   fit[t, n, ca] = AND_uk ( unchosen[ca, uk]
//                           | (dem_rx[t, ca, uk] <= free_rx[n, uk]
//                              & dem_tx[t, ca, uk] <= free_tx[n, uk]) )
//                   & valid[n, ca] & (pci_ok[n, ca] | !map_pci[t])
// reshaped to [C, A] per (t, n); then any, the first true pick (argmax
// semantics: 0 when none) and the count over A.
//
// The TPU kernel streamed 128-node blocks through VMEM in a sequential
// grid and unrolled the U*K slot loop. Here one thread owns one output
// element (t, n, c) and loops over the A picks and the U*K slots itself;
// nothing carries between blocks. A pick whose gate (valid, PCI) fails
// skips its slot loop, and a slot that fails ends it, so the work follows
// the data. The [T, N, C, A] lattice never leaves registers.
//
// Bound: bytes, at every bucket chip_smoke.py measures: the [T, C*A, U*K]
// demand rows, the [N, C*A] masks and the [T, N, C] outputs outweigh the
// compares (at most two per chosen slot per gated (t, n, ca), fewer where
// a slot fails early). The demand rows are shared by every node and stay
// in L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void nic_any_first_kernel(
    const float* __restrict__ free_rx,     // [N, UK]
    const float* __restrict__ free_tx,     // [N, UK]
    const float* __restrict__ dem_rx,      // [T, CA, UK]
    const float* __restrict__ dem_tx,      // [T, CA, UK]
    const uint8_t* __restrict__ unchosen,  // [CA, UK]
    const uint8_t* __restrict__ valid,     // [N, CA]
    const uint8_t* __restrict__ pci_ok,    // [N, CA]
    const uint8_t* __restrict__ map_pci,   // [T]
    uint8_t* __restrict__ nic_any,         // [T, N, C]
    int32_t* __restrict__ first_a,         // [T, N, C]
    int32_t* __restrict__ n_picks,         // [T, N, C]
    int T, int N, int UK, int C, int A)
{
    const long long NC = (long long)N * C;
    const long long total = (long long)T * NC;
    const long long CA = (long long)C * A;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const int t = (int)(i / NC);
        const long long rem = i - (long long)t * NC;
        const int n = (int)(rem / C);
        const int c = (int)(rem - (long long)n * C);
        const bool pci = map_pci[t] != 0;
        const float* frx = free_rx + (long long)n * UK;
        const float* ftx = free_tx + (long long)n * UK;
        int count = 0;
        int first = -1;
        for (int a = 0; a < A; ++a) {
            const long long ca = (long long)c * A + a;
            const long long nca = (long long)n * CA + ca;
            bool ok = valid[nca] && (!pci || pci_ok[nca]);
            if (ok) {
                const float* drx = dem_rx + ((long long)t * CA + ca) * UK;
                const float* dtx = dem_tx + ((long long)t * CA + ca) * UK;
                const uint8_t* un = unchosen + ca * UK;
                for (int uk = 0; uk < UK; ++uk) {
                    if (!un[uk] && !(drx[uk] <= frx[uk] && dtx[uk] <= ftx[uk])) {
                        ok = false;
                        break;
                    }
                }
            }
            if (ok) {
                ++count;
                if (first < 0) first = a;
            }
        }
        nic_any[i] = count > 0 ? 1 : 0;
        first_a[i] = first < 0 ? 0 : first;
        n_picks[i] = count;
    }
}

extern "C" int nhd_nic_any_first(
    const void* free_rx, const void* free_tx,
    const void* dem_rx, const void* dem_tx,
    const void* unchosen, const void* valid, const void* pci_ok,
    const void* map_pci,
    void* nic_any, void* first_a, void* n_picks,
    int T, int N, int UK, int C, int A,
    int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)T * N * C;
    if (total == 0) return 0;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 2147483647LL) blocks = 2147483647LL;
    nic_any_first_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)free_rx, (const float*)free_tx,
        (const float*)dem_rx, (const float*)dem_tx,
        (const uint8_t*)unchosen, (const uint8_t*)valid,
        (const uint8_t*)pci_ok, (const uint8_t*)map_pci,
        (uint8_t*)nic_any, (int32_t*)first_a, (int32_t*)n_picks,
        T, N, UK, C, A);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_nic_any_first_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
