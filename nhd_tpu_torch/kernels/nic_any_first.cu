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
// Bound: bytes, at every bucket chip_smoke.py measures: the [T, C*A, U*K]
// demand rows, the [N, C*A] masks and the [T, N, C] outputs outweigh the
// compares (two per chosen slot of each gated (t, n, ca)). The kernel sits
// far above that bound: at the wide bucket its node loop is bound by
// instruction issue (slot compares, a ballot and two shared atomics per
// node and 32 picks); at the main path's buckets by the launch and a
// fixed cost per block (PERF.md).
//
// Design. The TPU kernel streamed 128-node blocks through VMEM in a
// sequential grid; nothing carries between CUDA blocks, so this kernel
// keeps only what it computes. The first port gave one thread to each
// (t, n, c), walking A picks x U*K slots in series: 8 warps per SM at the
// cfg4 G=2 bucket, masks read 49 bytes apart by neighbouring lanes, and a
// byte load of `unchosen` for every slot, chosen or not. Here:
//   * a block covers one type t, a run of whole combos and a tile of NB
//     nodes; a warp owns a 32-pick chunk of the flattened ca = c*A + a
//     axis and loops over the tile's nodes. A lane holds one pick for the
//     whole loop: the columns of its chosen slots (usually G of U*K) and
//     their demand sit in registers, read once, so a node costs the lane
//     one byte each of `valid` and `pci_ok` (contiguous across lanes, 8
//     nodes' worth loaded together) and two compares per chosen slot
//     against the node's headroom row, staged in shared memory per block;
//   * __ballot_sync gives the chunk's fit bits per node. Lane l settles
//     piece l of the chunk, the bits of one combo's range [c*A, (c+1)*A):
//     __popc of them goes to the (node, combo) count and the first set bit
//     (__ffs) to its first pick, by shared-memory atomics, since a combo
//     may straddle chunks and warps (any A, any C). The block writes the
//     [T, N, C] outputs once at the end;
//   * with fewer chunks than warps (cfg4 G=1: 14 picks) the warps of a
//     chunk split its nodes; with more, each warp starts at its own node
//     so that warps on one combo do not contend for its sums;
//   * picks choosing more than MAXS slots walk their row of `unchosen`
//     instead, and a headroom tile too large for shared memory is read
//     through L1: no limit on U*K;
//   * the host takes NB from 64, 32, 16, 8, the largest that still gives
//     two blocks per SM (one where all picks fit one chunk), so the cfg4
//     G=2 bucket (T=8, N=1024) spreads over all 132 SMs (NB=16, 512
//     blocks), G=1 and cfg3 run NB=32 (256 blocks) and the wide bucket
//     amortises its setup over 64 nodes.

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

constexpr int WARPS = 8;                    // warps per block, one 32-pick chunk each
constexpr int THREADS = WARPS * 32;
constexpr int MAXS = 4;                     // chosen slots a lane keeps in registers
constexpr int NODE_BATCH = 8;               // nodes whose masks load together
constexpr long long HEAD_BUDGET = 32 * 1024;  // shared bytes for the nodes' headroom
constexpr long long ACC_BUDGET = 16 * 1024;   // shared bytes for the per-combo sums
constexpr unsigned FULL = 0xffffffffu;

// bits [lo, hi) of a word, 0 <= lo < hi <= 32
__device__ __forceinline__ unsigned bit_range(int lo, int hi)
{
    const unsigned upto = hi >= 32 ? FULL : ((1u << hi) - 1u);
    return upto & ~((1u << lo) - 1u);
}

// One lane's pick in a warp's 32-pick chunk: its chosen slots (the first
// MAXS as headroom offsets and demand in registers), and the combo piece
// it settles.
struct Pick {
    bool in;           // a pick of the block's range
    long long ca;      // its index in [0, C*A)
    int ns;            // chosen slots
    int off[MAXS];     // their columns in a headroom row
    float2 dem[MAXS];  // their (rx, tx) demand
    int k;             // the combo of this lane's piece, from the block's first
    unsigned pmask;    // the chunk bits of piece k (0: no piece)
    int pbase;         // chunk bit b is pick pbase + b of combo k
};

__device__ __forceinline__ Pick setup_pick(
    const uint8_t* __restrict__ unchosen, const float* drx_t, const float* dtx_t,
    int UK, int A, long long lo, int span, int cb, int lane)
{
    Pick pk;
    const int p = cb + lane;
    pk.in = p < span;
    pk.ca = lo + (pk.in ? p : 0);
    pk.ns = 0;
#pragma unroll
    for (int s = 0; s < MAXS; ++s) {
        pk.off[s] = 0;
        pk.dem[s] = make_float2(0.f, 0.f);
    }
    if (pk.in) {
        const uint8_t* un = unchosen + pk.ca * UK;
        for (int w0 = 0; w0 < UK; w0 += 32) {
            const int nb = min(32, UK - w0);
            uint32_t bits = 0u;
#pragma unroll 8
            for (int b = 0; b < nb; ++b) bits |= (uint32_t)(un[w0 + b] == 0) << b;
            while (bits) {
                const int uk = w0 + __ffs(bits) - 1;
                bits &= bits - 1u;
#pragma unroll
                for (int s = 0; s < MAXS; ++s)
                    if (s == pk.ns) pk.off[s] = uk;
                ++pk.ns;
            }
        }
#pragma unroll
        for (int s = 0; s < MAXS; ++s)
            if (s < pk.ns)
                pk.dem[s] = make_float2(drx_t[pk.ca * UK + pk.off[s]],
                                        dtx_t[pk.ca * UK + pk.off[s]]);
    }
    const int len = min(32, span - cb);
    pk.k = cb / A + lane;
    const bool has_piece = pk.k <= (cb + len - 1) / A;
    pk.pmask = has_piece
        ? bit_range(max(pk.k * A - cb, 0), min((pk.k + 1) * A - cb, len)) : 0u;
    pk.pbase = has_piece ? cb - pk.k * A : 0;
    return pk;
}

// Node n's (rx, tx) headroom at slot uk: from its staged row j, or global.
template <bool STAGED>
__device__ __forceinline__ float2 head(
    const float2* s_head, const float* __restrict__ free_rx,
    const float* __restrict__ free_tx, long long n, int j, int UK, int uk)
{
    if constexpr (STAGED) return s_head[j * UK + uk];
    return make_float2(free_rx[n * UK + uk], free_tx[n * UK + uk]);
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS) nic_any_first_kernel(
    const float* __restrict__ free_rx,     // [N, UK]
    const float* __restrict__ free_tx,     // [N, UK]
    const float* __restrict__ dem_rx,      // [T, CA, UK]
    const float* __restrict__ dem_tx,      // [T, CA, UK]
    const uint8_t* __restrict__ unchosen,  // [CA, UK]
    const uint8_t* __restrict__ valid,     // [N, CA]
    const uint8_t* __restrict__ pci_ok,    // [N, CA]
    const uint8_t* __restrict__ map_pci,   // [T]
    const int32_t* __restrict__ gate,      // [1]: 0 = a dead megaround bucket
    uint8_t* __restrict__ nic_any,         // [T, N, C]
    int32_t* __restrict__ first_a,         // [T, N, C]
    int32_t* __restrict__ n_picks,         // [T, N, C]
    int T, int N, int UK, int C, int A,
    int nodes_per_block, int combos_per_block)
{
    const int open = *gate;  // 0: nothing reaches device memory
    const int NB = nodes_per_block;
    const int CPB = combos_per_block;
    extern __shared__ __align__(16) unsigned char smem[];
    int* s_count = reinterpret_cast<int*>(smem);        // [NB, CPB] passing picks
    int* s_first = s_count + NB * CPB;                   // [NB, CPB] first one
    float2* s_head = reinterpret_cast<float2*>(s_first + NB * CPB);  // [NB, UK]

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.z;
    const long long CA = (long long)C * A;
    const int c0 = blockIdx.y * CPB;
    const int ncomb = min(C, c0 + CPB) - c0;
    const long long lo = (long long)c0 * A;   // the block's picks: lo + [0, span)
    const int span = ncomb * A;
    const long long n0 = (long long)blockIdx.x * NB;
    const int nodes = (int)min((long long)NB, N - n0);
    const uint32_t no_pci = map_pci[t] != 0 ? 0u : 1u;
    const float* drx_t = dem_rx + (long long)t * CA * UK;
    const float* dtx_t = dem_tx + (long long)t * CA * UK;

    for (int i = threadIdx.x; i < nodes * CPB; i += THREADS) {
        s_count[i] = 0;
        s_first[i] = INT_MAX;
    }
    if constexpr (STAGED) {
        for (int i = threadIdx.x; i < nodes * UK; i += THREADS)
            s_head[i] = make_float2(free_rx[n0 * UK + i], free_tx[n0 * UK + i]);
    }
    __syncthreads();
    if (!open) return;  // the whole block: the gate's load beside the staging's

    // Warps over (chunk, nodes): with at least WARPS chunks a warp takes
    // every WARPS-th chunk and all nodes, starting at its own node so that
    // warps on one combo do not meet on its sums; with fewer, the warps of
    // a chunk split its nodes.
    const int nch = (span + 31) >> 5;
    const int slices = nch >= WARPS ? 1 : WARPS / nch;
    const int slice = nch >= WARPS ? 0 : warp / nch;
    const int cnt = (nodes - slice + slices - 1) / slices;   // this warp's nodes
    const int stagger = slices == 1 ? (warp * cnt) / WARPS : 0;
    const int ci0 = nch >= WARPS ? warp : (warp < nch * slices ? warp % nch : nch);
    for (int ci = ci0; ci < nch; ci += (nch >= WARPS ? WARPS : nch)) {   // warp-uniform
        const Pick pk = setup_pick(unchosen, drx_t, dtx_t, UK, A, lo, span, ci * 32, lane);
        const bool dense = pk.ns > MAXS;   // more chosen slots than registers: walk all
        const uint8_t* un = unchosen + pk.ca * UK;
        const uint8_t* vcol = valid + n0 * CA + pk.ca;
        const uint8_t* pcol = pci_ok + n0 * CA + pk.ca;

        for (int q0 = 0; q0 < cnt; q0 += NODE_BATCH) {
            // the batch's mask bytes, all loaded before any is used
            uint8_t vb[NODE_BATCH], pb[NODE_BATCH];
#pragma unroll
            for (int u = 0; u < NODE_BATCH; ++u) {
                int q = q0 + u + stagger;
                q -= q >= cnt ? cnt : 0;
                const long long at = q0 + u < cnt ? (long long)(slice + q * slices) * CA : 0;
                vb[u] = vcol[at];
                pb[u] = pcol[at];
            }
            uint32_t gates = 0u;
#pragma unroll
            for (int u = 0; u < NODE_BATCH; ++u)
                gates |= (uint32_t)(pk.in & (vb[u] != 0) & ((pb[u] != 0) | no_pci)) << u;

#pragma unroll
            for (int u = 0; u < NODE_BATCH; ++u) {
                if (q0 + u >= cnt) break;   // warp-uniform
                int q = q0 + u + stagger;
                q -= q >= cnt ? cnt : 0;
                const int j = slice + q * slices;
                bool ok = (gates >> u) & 1u;
                if (ok) {
#pragma unroll
                    for (int s = 0; s < MAXS; ++s) {
                        if (s < pk.ns && !dense) {
                            const float2 h = head<STAGED>(s_head, free_rx, free_tx,
                                                          n0 + j, j, UK, pk.off[s]);
                            ok = ok & (pk.dem[s].x <= h.x) & (pk.dem[s].y <= h.y);
                        }
                    }
                    for (int uk = 0; uk < UK && ok && dense; ++uk) {
                        if (un[uk] == 0) {
                            const float2 h = head<STAGED>(s_head, free_rx, free_tx,
                                                          n0 + j, j, UK, uk);
                            ok = drx_t[pk.ca * UK + uk] <= h.x && dtx_t[pk.ca * UK + uk] <= h.y;
                        }
                    }
                }
                const unsigned m = __ballot_sync(FULL, ok) & pk.pmask;
                if (m) {
                    atomicAdd(s_count + j * CPB + pk.k, __popc(m));
                    atomicMin(s_first + j * CPB + pk.k, pk.pbase + __ffs(m) - 1);
                }
            }
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < nodes * ncomb; i += THREADS) {
        const int j = i / ncomb;
        const int kk = i - j * ncomb;
        const int n_pass = s_count[j * CPB + kk];
        const long long at = ((long long)t * N + n0 + j) * C + c0 + kk;
        nic_any[at] = n_pass > 0 ? 1 : 0;
        first_a[at] = n_pass > 0 ? s_first[j * CPB + kk] : 0;
        n_picks[at] = n_pass;
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

struct Plan {
    int nodes_per_block;
    int combos_per_block;
    long long ncg;      // combo groups
    long long blocks;   // node tiles
    bool staged;        // the nodes' headroom in shared memory
    long long smem;
};

// Nodes per block: the largest of 64, 32, 16, 8 that still gives two
// blocks per SM, or one where all picks fit one 32-lane chunk (then the
// warps of a block split its nodes, and larger blocks spread the fixed
// cost of a block over more of them); combos per block: as many as the
// sums' budget holds.
Plan plan(int T, int N, int UK, int C, int A, int device)
{
    const long long want = ((long long)C * A <= 32 ? 1LL : 2LL) * sm_count(device);
    Plan pl{};
    for (int nb = 64; nb >= 8; nb /= 2) {
        const long long cpb_fit = ACC_BUDGET / (8LL * nb);
        const long long cpb = cpb_fit < 1 ? 1 : (cpb_fit < C ? cpb_fit : C);
        pl.nodes_per_block = nb;
        pl.combos_per_block = (int)cpb;
        pl.ncg = (C + cpb - 1) / cpb;
        pl.blocks = ((long long)N + nb - 1) / nb;
        if ((long long)T * pl.ncg * pl.blocks >= want) break;
    }
    const long long rows = 8LL * pl.nodes_per_block * UK;
    pl.staged = rows <= HEAD_BUDGET;
    pl.smem = 8LL * pl.nodes_per_block * pl.combos_per_block + (pl.staged ? rows : 0);
    return pl;
}

template <bool STAGED>
cudaError_t launch(
    const Plan& pl,
    const void* free_rx, const void* free_tx, const void* dem_rx,
    const void* dem_tx, const void* unchosen, const void* valid,
    const void* pci_ok, const void* map_pci, const void* gate,
    void* nic_any, void* first_a, void* n_picks,
    int T, int N, int UK, int C, int A, cudaStream_t stream)
{
    nic_any_first_kernel<STAGED><<<dim3((unsigned)pl.blocks, (unsigned)pl.ncg, (unsigned)T),
                                   THREADS, (size_t)pl.smem, stream>>>(
        (const float*)free_rx, (const float*)free_tx,
        (const float*)dem_rx, (const float*)dem_tx,
        (const uint8_t*)unchosen, (const uint8_t*)valid,
        (const uint8_t*)pci_ok, (const uint8_t*)map_pci, (const int32_t*)gate,
        (uint8_t*)nic_any, (int32_t*)first_a, (int32_t*)n_picks,
        T, N, UK, C, A, pl.nodes_per_block, pl.combos_per_block);
    return cudaGetLastError();
}

}  // namespace

extern "C" int nhd_nic_any_first(
    const void* free_rx, const void* free_tx,
    const void* dem_rx, const void* dem_tx,
    const void* unchosen, const void* valid, const void* pci_ok,
    const void* map_pci, const void* gate,
    void* nic_any, void* first_a, void* n_picks,
    int T, int N, int UK, int C, int A,
    int device, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if ((long long)T * N * C == 0) return 0;
    if (UK < 0 || A < 1 || (long long)C * A > INT_MAX) return (int)cudaErrorInvalidValue;
    const Plan pl = plan(T, N, UK, C, A, device);
    if (T > 65535 || pl.ncg > 65535 || pl.blocks > INT_MAX)
        return (int)cudaErrorInvalidConfiguration;
    err = pl.staged
        ? launch<true>(pl, free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok,
                       map_pci, gate, nic_any, first_a, n_picks, T, N, UK, C, A,
                       (cudaStream_t)stream)
        : launch<false>(pl, free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok,
                        map_pci, gate, nic_any, first_a, n_picks, T, N, UK, C, A,
                        (cudaStream_t)stream);
    return (int)err;
}

extern "C" const char* nhd_nic_any_first_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
