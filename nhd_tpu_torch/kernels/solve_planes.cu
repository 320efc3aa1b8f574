// solve_planes: the rest of the feasibility solve plus the selection value,
// for Hopper (sm_90a).
//
// Replaces the XLA program of the reference's fused solve + rank
// (nhd_tpu/solver/kernel.py:41-204 _solve, :320-338 _policy_pref and the
// sel value of _rank_body :304-308), minus the NIC stage, which
// nic_any_first computes and this kernel reads. Per (type t, node n), over
// the C NUMA combos and U misc slots:
//   node_ok   active, not in maintenance, hugepages, the 64-bit group-mask
//             AND, and not busy for GPU pods
//   feasible  node_ok & combo uses only the node's NUMA nodes & GPU fit
//             & CPU fit for some misc slot (SMT or raw demand) & nic_any
//   best_c    first maximum of skew*(C+1) + (C-c) over feasible combos
//             (0 when none is feasible: every value is -1, the first wins)
//   best_m    first misc slot whose CPU fit holds at best_c (0 when none)
//   best_a, n_picks   the NIC stage's values at best_c
//   pref      1 + (CPU-only pod on a GPU-less node) where a candidate
//   sel       (pref + 3*class score) * (n_global+1) + (n_global - (node_base+n))
//             where a candidate, else 0: node_base is the first global row of
//             these N (a node shard's offset on a mesh) and n_global the
//             padded node count of the whole axis, so a shard's sel is the
//             unsharded solve's at the same node (0 and N on one device)
// and writes eight [T, N] int32 planes, in this order:
//   sel, cand, pref, best_c, best_m, best_a, n_combos, n_picks.
// The [T, N, C, M] CPU lattice and the [T, N, C] feasibility never reach
// memory. Integer compares stand in for the reference's float32 compares
// of integer demands: exact for every value below 2^24.
//
// Bound: bytes. Per (t, n) the work is O(C*U*G) integer compares on a few
// dozen bytes of node state; the [T, N, C] NIC planes and the eight output
// planes dominate the traffic. At the main path's buckets the kernel is
// latency-bound: about 3 us above an empty launch of the same grid.
//
// Design. The first port gave one thread to each (t, n), walking the
// combos in series and redoing the CPU fit of best_c; at the cfg4 G=2
// bucket that was 32 blocks of 256 threads for 132 SMs, each thread
// reading the type's rows and the combo tables from global memory. Here:
//   * a group of L lanes (C rounded up to a power of two, at most 32)
//     owns one (t, n); lane c evaluates combo c (and c + L, ... when C >
//     32): its GPU fit, and the CPU fit of each misc slot up to the first
//     that holds, which is its best_m. A butterfly of __shfl_xor_sync
//     inside the group sums n_combos and takes the maximum of the key
//     (value, -c), the first-maximum rule; the winning lane's best_m,
//     first_a and n_picks travel with the key, so no fit is recomputed;
//   * after the butterfly every lane of the group holds the answer, and
//     lane p writes plane p: neighbouring groups write neighbouring n;
//   * a block covers one type t and a tile of nodes. The type's demand
//     rows and class-score row, the combo tables (combo, maxdig, skew)
//     and the tile's cpu_free/gpu_free rows go to shared memory once per
//     block, every load of a thread's share issued before its first
//     store (all read from global memory where they exceed 48 KB); the
//     node's scalars and the lane's first NIC values load before that, so
//     a block waits on about two memory round trips in all;
//   * the host halves the block (256 down to 64 threads) until the grid
//     has two blocks per SM, so the G=1 bucket (L=2) fills the card too.
// The 64-bit group-mask AND stays `long long` (the JAX reference cuts it
// to 32 bits; the port does not).

// Gate: *gate* is one int32 word of the megaround's control tensor (the
// bucket's live flag, written by spec_gate.cu). Where it is 0 every block
// returns before it writes device memory: a dead iteration of the
// fixed-trip megaround, or a bucket with no need left. Its load issues
// beside the kernel's first loads and is tested after them, so a live
// launch waits for no extra round trip. Outside the megaround it is a
// word that is always 1.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 256;
constexpr int MIN_THREADS = 64;
constexpr long long SMEM_BUDGET = 48 * 1024;
constexpr int STAGE_BATCH = 4;   // staged elements a thread loads at once

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
    const int32_t* __restrict__ gate,          // [1]: 0 = a dead megaround bucket
    int32_t* __restrict__ out,                 // [8, T, N]
    int T, int N, int U, int G, int C, int NCLS, int L, int staged,
    int node_base, int n_global)
{
    const int open = *gate;  // 0: nothing reaches device memory
    const int t = blockIdx.y;
    const int sub = threadIdx.x & (L - 1);
    const int per_block = blockDim.x / L;
    const long long n0 = (long long)blockIdx.x * per_block;
    const int local = threadIdx.x / L;
    const long long n = n0 + local;
    const bool live = n < N;
    const long long nr = live ? n : 0;

    // the node's scalars and the type's: independent loads, issued first
    const int hp_t = hp[t];
    const bool gpu_pod = needs_gpu[t] != 0;
    const long long gmask_t = pod_gmask[t];
    const int nn = numa_nodes[nr];
    const bool smt_n = smt[nr] != 0;
    const bool node_ok = live & (active[nr] != 0) & (maintenance[nr] == 0)
        & (hp_t <= hp_free[nr]) & ((gmask_t & node_gmask[nr]) != 0)
        & (!gpu_pod | (busy[nr] == 0));
    const bool gpuless_n = gpuless[nr] != 0;
    int cls = node_class[nr];

    // staged once per block: the type's rows, the combo tables and the
    // block's node rows of cpu_free and gpu_free
    extern __shared__ int32_t sm[];
    const int n_rows = 2 * (G + 1) + G + NCLS;
    const int n_tab = C * G + 2 * C;
    const int n_node = per_block * U;
    // the lane's first combo's NIC values, loaded before the barrier
    const long long row = ((long long)t * N + nr) * C;
    const bool first_live = live && sub < C;
    const bool nic0 = first_live && nic_any[row + sub] != 0;
    const int a0 = first_live ? first_a[row + sub] : 0;
    const int p0 = first_live ? n_picks[row + sub] : 0;
    if (!open) return;  // the whole block: the gate's load beside the scalars'
    if (staged) {
        const long long row_base = n0 * U;
        const long long node_end = (long long)N * U;
        const int total = n_rows + n_tab + 2 * n_node;
        for (int i0 = threadIdx.x; i0 < total; i0 += STAGE_BATCH * blockDim.x) {
            int v[STAGE_BATCH];   // every load of the batch issues before any store
#pragma unroll
            for (int u = 0; u < STAGE_BATCH; ++u) {
                const int i = i0 + u * blockDim.x;
                v[u] = 0;
                if (i >= total) {
                } else if (i < G + 1) {
                    v[u] = cpu_dem_smt[(long long)t * (G + 1) + i];
                } else if (i < 2 * (G + 1)) {
                    v[u] = cpu_dem_raw[(long long)t * (G + 1) + i - (G + 1)];
                } else if (i < 2 * (G + 1) + G) {
                    v[u] = gpu_dem[(long long)t * G + i - 2 * (G + 1)];
                } else if (i < n_rows) {
                    v[u] = class_score[(long long)t * NCLS + i - (2 * (G + 1) + G)];
                } else if (i < n_rows + C * G) {
                    v[u] = combo[i - n_rows];
                } else if (i < n_rows + C * G + C) {
                    v[u] = maxdig[i - n_rows - C * G];
                } else if (i < n_rows + n_tab) {
                    v[u] = skew[i - n_rows - C * G - C];
                } else {
                    const int j = i - n_rows - n_tab;
                    const long long at = row_base + (j < n_node ? j : j - n_node);
                    if (at < node_end) v[u] = j < n_node ? cpu_free[at] : gpu_free[at];
                }
            }
#pragma unroll
            for (int u = 0; u < STAGE_BATCH; ++u) {
                const int i = i0 + u * blockDim.x;
                if (i < total) sm[i] = v[u];
            }
        }
        __syncthreads();
    }
    const int32_t* d_smt = staged ? sm : cpu_dem_smt + (long long)t * (G + 1);
    const int32_t* d_raw = staged ? sm + G + 1 : cpu_dem_raw + (long long)t * (G + 1);
    const int32_t* gdem = staged ? sm + 2 * (G + 1) : gpu_dem + (long long)t * G;
    const int32_t* score_row = staged ? sm + 2 * (G + 1) + G : class_score + (long long)t * NCLS;
    const int32_t* tcombo = staged ? sm + n_rows : combo;
    const int32_t* tmaxdig = staged ? sm + n_rows + C * G : maxdig;
    const int32_t* tskew = staged ? sm + n_rows + C * G + C : skew;
    const int32_t* cfree = staged ? sm + n_rows + n_tab + local * U : cpu_free + nr * U;
    const int32_t* gfree = staged ? sm + n_rows + n_tab + n_node + local * U : gpu_free + nr * U;
    const int32_t* dem = smt_n ? d_smt : d_raw;

    // this lane's combos: count, and the first maximum of (value, -c)
    int count = 0;
    int b_val = INT_MIN, b_c = INT_MAX, b_m = 0, b_a = 0, b_p = 0;
    for (int c = sub; live && c < C; c += L) {
        const bool nic = c == sub ? nic0 : nic_any[row + c] != 0;
        const int a = c == sub ? a0 : first_a[row + c];
        const int p = c == sub ? p0 : n_picks[row + c];
        const int32_t* combo_c = tcombo + (long long)c * G;
        bool feasible = node_ok & nic & (tmaxdig[c] < nn);
        for (int u = 0; u < U && feasible; ++u)
            feasible = group_need(gdem, combo_c, G, u) <= gfree[u];
        // best_m is read at best_c even where best_c is infeasible
        int m_first = -1;
        for (int m = 0; m < U && m_first < 0; ++m)
            if (cpu_fit(dem, combo_c, cfree, G, U, m)) m_first = m;
        feasible = feasible && m_first >= 0;
        const int val = feasible ? tskew[c] * (C + 1) + (C - c) : -1;
        if (val > b_val) {   // c rises: strict > keeps the first maximum
            b_val = val;
            b_c = c;
            b_m = m_first < 0 ? 0 : m_first;
            b_a = a;
            b_p = p;
        }
        count += feasible ? 1 : 0;
    }
    for (int off = L >> 1; off > 0; off >>= 1) {
        const int o_val = __shfl_xor_sync(FULL, b_val, off);
        const int o_c = __shfl_xor_sync(FULL, b_c, off);
        const int o_m = __shfl_xor_sync(FULL, b_m, off);
        const int o_a = __shfl_xor_sync(FULL, b_a, off);
        const int o_p = __shfl_xor_sync(FULL, b_p, off);
        count += __shfl_xor_sync(FULL, count, off);
        if (o_val > b_val || (o_val == b_val && o_c < b_c)) {
            b_val = o_val;
            b_c = o_c;
            b_m = o_m;
            b_a = o_a;
            b_p = o_p;
        }
    }
    if (!live) return;

    const bool cand = count > 0;
    const int pref = cand ? 1 + ((!gpu_pod && gpuless_n) ? 1 : 0) : 0;
    cls = cls < 0 ? 0 : (cls > NCLS - 1 ? NCLS - 1 : cls);
    const int sel = cand
        ? (pref + 3 * score_row[cls]) * (n_global + 1) + (n_global - (node_base + (int)n))
        : 0;
    const long long TN = (long long)T * N;
    const long long at = (long long)t * N + n;
    for (int p = sub; p < 8; p += L) {
        int v;
        switch (p) {
            case 0: v = sel; break;
            case 1: v = cand ? 1 : 0; break;
            case 2: v = pref; break;
            case 3: v = b_c; break;
            case 4: v = b_m; break;
            case 5: v = b_a; break;
            case 6: v = count; break;
            default: v = b_p; break;
        }
        out[p * TN + at] = v;
    }
}

int sm_count(int device)
{
    static int cached[64] = {0};
    if (device >= 0 && device < 64 && cached[device] > 0) return cached[device];
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess
        || sms < 1)
        sms = 132;
    if (device >= 0 && device < 64) cached[device] = sms;
    return sms;
}

}  // namespace

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
    const void* gate, void* out,
    int T, int N, int U, int G, int C, int NCLS, int node_base, int n_global,
    int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if ((long long)T * N == 0) return 0;
    if (C < 1 || NCLS < 1 || T > 65535 || node_base < 0 || n_global < node_base + N)
        return (int)cudaErrorInvalidValue;
    int L = 1;
    while (L < C && L < 32) L *= 2;
    // halve the block until the grid has two blocks per SM
    const long long want = 2LL * sm_count(device);
    int threads = MAX_THREADS;
    while (threads > MIN_THREADS
           && (long long)T * (((long long)N + threads / L - 1) / (threads / L)) < want)
        threads /= 2;
    const long long per_block = threads / L;
    const long long blocks = ((long long)N + per_block - 1) / per_block;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    const long long words = 2LL * (G + 1) + G + NCLS + (long long)C * G + 2LL * C
        + 2LL * per_block * U;
    const bool staged = words * 4 <= SMEM_BUDGET;
    solve_planes_kernel<<<dim3((unsigned)blocks, (unsigned)T), threads,
                          staged ? (size_t)(words * 4) : 0,
                          (cudaStream_t)stream>>>(
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
        (const int32_t*)n_picks, (const int32_t*)gate, (int32_t*)out,
        T, N, U, G, C, NCLS, L, staged ? 1 : 0, node_base, n_global);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_solve_planes_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
