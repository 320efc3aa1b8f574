// rank_merge: the top R across a mesh's shards, for Hopper (sm_90a).
//
// On a node-sharded mesh the reference runs its fused solve+rank program
// (nhd_tpu/solver/kernel.py get_ranked_solver_mesh, the lax.top_k of
// _rank_body at :297-317 over the sharded node axis) under GSPMD, which
// inserts the cross-shard top-k. The port ranks each shard with
// rank_top.cu (its top min(R, shard rows), indices made global) and joins
// the shards' candidates in shard order; this kernel takes that [9, T, M]
// tensor and, one block per type row t:
//   winners = the R largest cand[0][t], equal values in ascending position
//             (lax.top_k's order), in that order;
//   out[r]  = cand[r][t] at the winners, for each of the nine rows.
// A shard's zero-valued candidates are its lowest-index zero nodes in
// ascending order and the shards come in order, so the val-0 slots are
// the unsharded rank's as well: a shard of k = min(R, rows) candidates
// holds at least as many zero nodes as the global top R takes from it.
// The kernel equals its plain version (kernels/reference.py rank_merge)
// bit for bit.
//
// Bound: the launch. At cfg4 over 4 shards (M = 4 * 256, R = 512) a row
// needs 4 KB of keys, 9 * R words gathered and 9 * R written. The
// selection is rank_top.cu's (kept in this file too: each library hashes
// its own source): the keys staged in shared memory where they fit, a
// radix select of 8-bit passes from the highest byte where the keys
// differ for the threshold, one ordered pass that compacts the winners
// (the first k_eq equal keys by position) as 64-bit words (key above the
// position's complement), a bitonic sort of them (shuffles within a warp,
// shared memory across warps), then one thread a slot copies its nine
// words. Past THREADS winners the list lives in rows 2-4 of the type
// row's output, ordered by counting, until the copy overwrites them after
// a barrier.
//
// Gate: *gate* is one int32 word, always 1 on the rank's path
// (kernels.live_gate); where it is 0 the block returns before it writes
// device memory.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t STAGE_BYTES = 200 * 1024;   // dynamic shared memory budget
constexpr int RANK = 9;                      // the rows of a candidate

__device__ __forceinline__ unsigned key_of(int v) { return (unsigned)v ^ 0x80000000u; }
__device__ __forceinline__ int val_of(unsigned k) { return (int)(k ^ 0x80000000u); }

// The R-th largest of keys[0 .. n) (as key_of images): *thr*, and how many
// keys equal to it the top R takes, *k_eq* (1 <= k_eq). The bytes above
// the highest bit where the smallest and largest key differ are common to
// every key, so the passes start below them (sel stays under 2^24 up to
// 21,000 node rows: two or three passes, not four), and none runs when
// every key is equal.
__device__ void radix_select(const int32_t* keys, int n, int R, int* hist,
                             int* s_pick, unsigned* s_span, unsigned& thr,
                             int& k_eq)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) {
        s_span[0] = ~0u;
        s_span[1] = 0u;
    }
    __syncthreads();
    unsigned lo = ~0u, hi = 0u;
    for (int i = threadIdx.x; i < n; i += THREADS) {
        const unsigned u = key_of(keys[i]);
        lo = min(lo, u);
        hi = max(hi, u);
    }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    if (lane == 0) {
        atomicMin(&s_span[0], lo);
        atomicMax(&s_span[1], hi);
    }
    __syncthreads();
    lo = s_span[0];
    const unsigned differ = lo ^ s_span[1];
    int k = R;  // the rank, from the top and 1-based, still to place
    if (differ == 0u) {  // every key equal
        thr = lo;
        k_eq = k;
        return;
    }
    const int top = (31 - __clz(differ)) & ~7;  // the highest differing byte
    unsigned mask = top == 24 ? 0u : ~0u << (top + 8);
    unsigned prefix = lo & mask;
    for (int shift = top; shift >= 0; shift -= 8) {
        for (int b = threadIdx.x; b < BINS; b += THREADS) hist[b] = 0;
        __syncthreads();
        for (int base = 0; base < n; base += THREADS) {
            const int i = base + threadIdx.x;
            unsigned bin = BINS;  // none
            if (i < n) {
                const unsigned u = key_of(keys[i]);
                if ((u & mask) == prefix) bin = (u >> shift) & (BINS - 1);
            }
            const unsigned peers = __match_any_sync(FULL, bin);
            if (bin < BINS && lane == __ffs(peers) - 1)
                atomicAdd(&hist[bin], __popc(peers));
        }
        __syncthreads();
        if (warp == 0) {
            // lane l holds bins 255 - 8l down to 248 - 8l: an inclusive
            // scan over the lanes counts the keys from the top bin down
            int c[8], s = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                c[j] = hist[BINS - 1 - 8 * lane - j];
                s += c[j];
            }
            int inc = s;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int v = __shfl_up_sync(FULL, inc, o);
                if (lane >= o) inc += v;
            }
            int run = inc - s;
            if (run < k && k <= inc) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (run + c[j] >= k) {
                        s_pick[0] = BINS - 1 - 8 * lane - j;
                        s_pick[1] = run;
                        break;
                    }
                    run += c[j];
                }
            }
        }
        __syncthreads();
        prefix |= (unsigned)s_pick[0] << shift;
        mask |= (unsigned)(BINS - 1) << shift;
        k -= s_pick[1];
    }
    thr = prefix;
    k_eq = k;
}

// The top R of keys[0 .. n), unordered: every key above thr and the first
// k_eq keys equal to it by position, as words word_of(key, position) into
// *sorted* or, where it is null, as keys and positions into wkey/wpos.
__device__ __forceinline__ unsigned long long word_of(unsigned u, int i)
{
    return ((unsigned long long)u << 32) | (unsigned)~(unsigned)i;
}

__device__ void compact(const int32_t* keys, int n, int R, unsigned thr,
                        int k_eq, unsigned long long* sorted, unsigned* wkey,
                        int* wpos, int* s_warp, int* s_count)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    if (threadIdx.x == 0) *s_count = 0;
    __syncthreads();
    int carry = 0;  // keys equal to thr before this chunk
    for (int base = 0; base < n; base += THREADS) {
        const int i = base + threadIdx.x;
        const unsigned u = i < n ? key_of(keys[i]) : 0u;
        const bool eq = i < n && u == thr;
        const unsigned eqb = __ballot_sync(FULL, eq);
        if (lane == 0) s_warp[warp] = __popc(eqb);
        __syncthreads();
        int before = 0, total = 0;
        for (int w = 0; w < WARPS; ++w) {
            const int c = s_warp[w];
            before += w < warp ? c : 0;
            total += c;
        }
        const bool win = (i < n && u > thr)
            || (eq && carry + before + __popc(eqb & lt) < k_eq);
        const unsigned wb = __ballot_sync(FULL, win);
        int slot = 0;
        if (lane == 0 && wb) slot = atomicAdd(s_count, __popc(wb));
        slot = __shfl_sync(FULL, slot, 0) + __popc(wb & lt);
        if (win) {
            if (sorted != nullptr) {
                sorted[slot] = word_of(u, i);
            } else {
                wkey[slot] = u;
                wpos[slot] = i;
            }
        }
        carry += total;
        __syncthreads();
        if (*s_count == R) break;  // every winner found (read after the barrier)
    }
}

// A descending bitonic sort of P <= THREADS words, P a power of two,
// thread i holding word i in *v*: pairs less than a warp apart exchange
// through shuffles, farther ones through s[0 .. P) (two barriers a step:
// log2(P / 32) * (log2(P / 32) + 1) / 2 steps, 10 at P = 512). Returns the
// word thread i holds at the end, the i-th largest. Every thread of the
// block calls it.
__device__ unsigned long long bitonic_desc(unsigned long long* s, int P,
                                              unsigned long long v)
{
    const int i = threadIdx.x;
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            unsigned long long o;
            if (j >= 32) {
                __syncthreads();  // every read of s in the last step is done
                if (i < P) s[i] = v;
                __syncthreads();
                o = i < P ? s[i ^ j] : 0ull;
            } else {
                o = __shfl_xor_sync(FULL, v, j);
            }
            // a descending run where (i & k) == 0: its lower index keeps
            // the larger word; an ascending run the smaller
            const bool larger = ((i & k) == 0) == ((i & j) == 0);
            v = larger ? (v > o ? v : o) : (v < o ? v : o);
        }
    }
    return v;
}

// Past THREADS winners: scratch[i] = the winners before winner i (a
// greater key, or an equal key at a lower position).
__device__ void order_by_count(const unsigned* wkey, const int* wpos, int R,
                               int32_t* scratch)
{
    for (int i = threadIdx.x; i < R; i += THREADS) {
        const unsigned ki = wkey[i];
        const int pi = wpos[i];
        int r = 0;
        for (int j = 0; j < R; ++j) {
            const unsigned kj = wkey[j];
            r += (kj > ki) | ((kj == ki) & (wpos[j] < pi));
        }
        scratch[i] = r;
    }
}

// The top R of keys[0 .. n) in order, each winner's key into row[0][slot]
// and its position into row[1][slot] (rows of the type row's output;
// rows 2-4 are scratch past THREADS winners). P: the sort's length, 0
// past THREADS winners. Ends on a barrier.
__device__ __forceinline__ void select_top(const int32_t* keys, int n, int R, int P,
                           unsigned long long* sorted, int32_t* const* row,
                           int* s_hist, int* s_pick, unsigned* s_span,
                           int* s_warp, int* s_count)
{
    unsigned thr;
    int k_eq;
    radix_select(keys, n, R, s_hist, s_pick, s_span, thr, k_eq);
    unsigned* wkey = (unsigned*)row[2];
    int* wpos = (int*)row[3];
    compact(keys, n, R, thr, k_eq, P ? sorted : nullptr, wkey, wpos, s_warp,
            s_count);
    if (P) {
        // thread j holds word j (zero past R) and ends holding the j-th
        const int j = threadIdx.x;
        const unsigned long long w = bitonic_desc(
            sorted, P, j < R ? sorted[j] : 0ull);
        if (j < R) {
            row[0][j] = val_of((unsigned)(w >> 32));
            row[1][j] = (int)~(unsigned)w;
        }
    } else {
        order_by_count(wkey, wpos, R, row[4]);
        __syncthreads();
        for (int i = threadIdx.x; i < R; i += THREADS) {
            const int r = row[4][i];
            row[0][r] = val_of(wkey[i]);
            row[1][r] = wpos[i];
        }
    }
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS) rank_merge_kernel(
    const int32_t* __restrict__ cand,  // [9, T, M]
    const int32_t* __restrict__ gate,  // [1]: 0 = return at once
    int32_t* __restrict__ out,         // [9, T, R]
    int T, int M, int R, bool stage, int P)
{
    const int open = *gate;  // 0: nothing reaches device memory
    if (!open) return;
    // the sort's P words first (8-byte aligned), then the staged keys
    extern __shared__ unsigned long long s_dyn[];
    __shared__ int s_hist[BINS];
    __shared__ int s_warp[WARPS];
    __shared__ int s_pick[2];
    __shared__ unsigned s_span[2];
    __shared__ int s_count;
    const int t = blockIdx.x;
    const int32_t* src[RANK];
    int32_t* row[RANK];
#pragma unroll
    for (int r = 0; r < RANK; ++r) {
        src[r] = cand + ((size_t)r * T + t) * M;
        row[r] = out + ((size_t)r * T + t) * R;
    }

    const int32_t* keys = src[0];
    if (stage) {
        int32_t* s_keys = (int32_t*)(s_dyn + P);
        for (int i = threadIdx.x; i < M; i += THREADS) s_keys[i] = src[0][i];
        keys = s_keys;  // radix_select's first barrier orders these writes
    }
    select_top(keys, M, R, P, s_dyn, row, s_hist, s_pick, s_span, s_warp,
               &s_count);
    for (int j = threadIdx.x; j < R; j += THREADS) {
        const int p = row[1][j];  // the winner's position among the candidates
#pragma unroll
        for (int r = 1; r < RANK; ++r) row[r][j] = src[r][p];
    }
}

}  // namespace

extern "C" int nhd_rank_merge(
    const void* cand, const void* gate, void* out, int T, int M, int R,
    int device, void* stream)
{
    if (T < 0 || M < 1 || M > INT_MAX - THREADS || R < 1 || R > M)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (T == 0) return 0;
    int P = 0;  // the sort's length: R's power of two, 0 past THREADS
    if (R <= THREADS)
        for (P = 1; P < R; P <<= 1) {}
    const size_t win = (size_t)P * sizeof(unsigned long long);
    const bool stage = (size_t)M * sizeof(int32_t) + win <= STAGE_BYTES;
    const size_t bytes = win + (stage ? (size_t)M * sizeof(int32_t) : 0);
    if (bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(rank_merge_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
        if (err != cudaSuccess) return (int)err;
    }
    rank_merge_kernel<<<(unsigned)T, THREADS, bytes, (cudaStream_t)stream>>>(
        (const int32_t*)cand, (const int32_t*)gate, (int32_t*)out, T, M, R,
        stage, P);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_rank_merge_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
