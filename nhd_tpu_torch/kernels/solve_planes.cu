// solve_planes: the rest of the feasibility solve plus the selection value,
// for Hopper (sm_90a).
//
// Replaces the XLA program of the reference's fused solve + rank
// (nhd_tpu/solver/kernel.py:41-204 _solve, :320-338 _policy_pref and the
// sel value of _rank_body :304-308), minus the NIC stage, which
// nic_any_first computes and this kernel reads. One thread per (type t,
// node n) walks the C NUMA combos and U misc slots:
//   node_ok   active, not in maintenance, hugepages, the 64-bit group-mask
//             AND, and not busy for GPU pods
//   feasible  node_ok & combo uses only the node's NUMA nodes & GPU fit
//             & CPU fit for some misc slot (SMT or raw demand) & nic_any
//   best_c    first maximum of skew*(C+1) + (C-c) over feasible combos
//   best_m    first misc slot whose CPU fit holds at best_c
//   best_a, n_picks   the NIC stage's values at best_c
//   pref      1 + (CPU-only pod on a GPU-less node) where a candidate
//   sel       (pref + 3*class score) * (N+1) + (N-n) where a candidate, else 0
// and writes eight [T, N] int32 planes, in this order:
//   sel, cand, pref, best_c, best_m, best_a, n_combos, n_picks.
// The [T, N, C, M] CPU lattice and the [T, N, C] feasibility never reach
// memory. Integer compares stand in for the reference's float32 compares
// of integer demands: exact for every value below 2^24.
//
// Bound: bytes. Per (t, n) the thread does O(C*U*G) integer work on a few
// dozen bytes of node state and writes 32 bytes; the [T, N, C] NIC planes
// and the outputs dominate the traffic.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int group_need(
    const int32_t* dem, const int32_t* combo_c, int G, int u)
{
    int s = 0;
    for (int g = 0; g < G; ++g) s += (combo_c[g] == u) ? dem[g] : 0;
    return s;
}

__device__ __forceinline__ bool cpu_fit(
    const int32_t* dem, const int32_t* combo_c, const int32_t* cfree,
    int G, int U, int m)
{
    const int misc = dem[G];
    for (int u = 0; u < U; ++u) {
        const int need = group_need(dem, combo_c, G, u) + (u == m ? misc : 0);
        if (need > cfree[u]) return false;
    }
    return true;
}

__global__ void solve_planes_kernel(
    const int8_t* __restrict__ numa_nodes,     // [N]
    const uint8_t* __restrict__ smt,           // [N]
    const uint8_t* __restrict__ active,        // [N]
    const uint8_t* __restrict__ maintenance,   // [N]
    const uint8_t* __restrict__ busy,          // [N]
    const uint8_t* __restrict__ gpuless,       // [N]
    const long long* __restrict__ node_gmask,  // [N]
    const int32_t* __restrict__ hp_free,       // [N]
    const int32_t* __restrict__ cpu_free,      // [N, U]
    const int32_t* __restrict__ gpu_free,      // [N, U]
    const int32_t* __restrict__ node_class,    // [N]
    const int32_t* __restrict__ cpu_dem_smt,   // [T, G+1]
    const int32_t* __restrict__ cpu_dem_raw,   // [T, G+1]
    const int32_t* __restrict__ gpu_dem,       // [T, G]
    const int32_t* __restrict__ hp,            // [T]
    const uint8_t* __restrict__ needs_gpu,     // [T]
    const long long* __restrict__ pod_gmask,   // [T]
    const int32_t* __restrict__ class_score,   // [T, NCLS]
    const int32_t* __restrict__ combo,         // [C, G]
    const int32_t* __restrict__ maxdig,        // [C]
    const int32_t* __restrict__ skew,          // [C]
    const uint8_t* __restrict__ nic_any,       // [T, N, C]
    const int32_t* __restrict__ first_a,       // [T, N, C]
    const int32_t* __restrict__ n_picks,       // [T, N, C]
    int32_t* __restrict__ out,                 // [8, T, N]
    int T, int N, int U, int G, int C, int NCLS)
{
    const long long TN = (long long)T * N;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < TN; i += stride) {
        const int t = (int)(i / N);
        const int n = (int)(i - (long long)t * N);

        const bool node_ok =
            active[n] && !maintenance[n] && hp[t] <= hp_free[n]
            && (pod_gmask[t] & node_gmask[n]) != 0
            && (!needs_gpu[t] || !busy[n]);
        const int32_t* dem =
            (smt[n] ? cpu_dem_smt : cpu_dem_raw) + (long long)t * (G + 1);
        const int32_t* gdem = gpu_dem + (long long)t * G;
        const int32_t* cfree = cpu_free + (long long)n * U;
        const int32_t* gfree = gpu_free + (long long)n * U;
        const long long nic_row = i * C;   // (t * N + n) * C
        const int nn = numa_nodes[n];

        int n_combos = 0;
        int best_c = 0;
        int best_val = 0;
        for (int c = 0; c < C; ++c) {
            const int32_t* combo_c = combo + (long long)c * G;
            bool feasible = node_ok && maxdig[c] < nn && nic_any[nic_row + c];
            for (int u = 0; u < U && feasible; ++u)
                feasible = group_need(gdem, combo_c, G, u) <= gfree[u];
            if (feasible) {
                bool any = false;
                for (int m = 0; m < U && !any; ++m)
                    any = cpu_fit(dem, combo_c, cfree, G, U, m);
                feasible = any;
            }
            const int val = feasible ? skew[c] * (C + 1) + (C - c) : -1;
            if (c == 0 || val > best_val) {
                best_val = val;
                best_c = c;
            }
            n_combos += feasible ? 1 : 0;
        }
        const bool cand = n_combos > 0;

        int best_m = 0;
        const int32_t* combo_b = combo + (long long)best_c * G;
        for (int m = 0; m < U; ++m) {
            if (cpu_fit(dem, combo_b, cfree, G, U, m)) {
                best_m = m;
                break;
            }
        }

        const int pref = cand ? 1 + ((!needs_gpu[t] && gpuless[n]) ? 1 : 0) : 0;
        int cls = node_class[n];
        cls = cls < 0 ? 0 : (cls > NCLS - 1 ? NCLS - 1 : cls);
        const int score = class_score[(long long)t * NCLS + cls];
        const int sel = cand ? (pref + 3 * score) * (N + 1) + (N - n) : 0;

        out[0 * TN + i] = sel;
        out[1 * TN + i] = cand ? 1 : 0;
        out[2 * TN + i] = pref;
        out[3 * TN + i] = best_c;
        out[4 * TN + i] = best_m;
        out[5 * TN + i] = first_a[nic_row + best_c];
        out[6 * TN + i] = n_combos;
        out[7 * TN + i] = n_picks[nic_row + best_c];
    }
}

extern "C" int nhd_solve_planes(
    const void* numa_nodes, const void* smt, const void* active,
    const void* maintenance, const void* busy, const void* gpuless,
    const void* node_gmask, const void* hp_free, const void* cpu_free,
    const void* gpu_free, const void* node_class,
    const void* cpu_dem_smt, const void* cpu_dem_raw, const void* gpu_dem,
    const void* hp, const void* needs_gpu, const void* pod_gmask,
    const void* class_score,
    const void* combo, const void* maxdig, const void* skew,
    const void* nic_any, const void* first_a, const void* n_picks,
    void* out,
    int T, int N, int U, int G, int C, int NCLS,
    int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)T * N;
    if (total == 0) return 0;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 2147483647LL) blocks = 2147483647LL;
    solve_planes_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)numa_nodes, (const uint8_t*)smt,
        (const uint8_t*)active, (const uint8_t*)maintenance,
        (const uint8_t*)busy, (const uint8_t*)gpuless,
        (const long long*)node_gmask, (const int32_t*)hp_free,
        (const int32_t*)cpu_free, (const int32_t*)gpu_free,
        (const int32_t*)node_class,
        (const int32_t*)cpu_dem_smt, (const int32_t*)cpu_dem_raw,
        (const int32_t*)gpu_dem, (const int32_t*)hp,
        (const uint8_t*)needs_gpu, (const long long*)pod_gmask,
        (const int32_t*)class_score,
        (const int32_t*)combo, (const int32_t*)maxdig, (const int32_t*)skew,
        (const uint8_t*)nic_any, (const int32_t*)first_a,
        (const int32_t*)n_picks, (int32_t*)out,
        T, N, U, G, C, NCLS);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_solve_planes_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
