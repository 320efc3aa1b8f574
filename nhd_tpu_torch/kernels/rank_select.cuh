// rank_select.cuh: the select/sort core of rank_top.cu and rank_merge.cu.
//
// Both kernels rank one row of int32 keys per block: the top R in
// descending order, equal keys in ascending position (lax.top_k's
// order), and hand each winner to an *emit* functor: emit.gather(key,
// position) loads that slot's nine words (a Slot), emit.write(slot, Slot)
// stores them, so that a thread's gathers for several slots are all
// issued before any of its stores. A key
// and its position travel as one 64-bit word, the key's order-preserving
// unsigned image (sign bit flipped) above the position's complement, so
// that one descending order of words is (key descending, position
// ascending) and the words of a row are distinct. The zero word is below
// every real word and pads a sort.
//
// Two regimes, by the row's length n:
//   * rank_whole (n <= WHOLE_MAX = 1,024: cfg4's and cfg3's buckets, every
//     mesh shard, the merge of 4 or 8 shards at cfg4): the whole row is
//     loaded straight into registers, WHOLE_PER words a thread (8- or
//     16-byte loads where the row is aligned); one barrier gives the
//     keys' span and whether the row is sorted already (every key equal,
//     as in a padded type row: then no step runs); the row is bitonic-
//     sorted as 32-bit words (key minus the smallest, above the
//     position's complement) where the span leaves the position's bits,
//     else as 64-bit ones, every loop unrolled: steps within a thread in
//     registers, within a warp through shuffles, and only those whose
//     partner lies beyond a warp's span through shared memory (10 of 55
//     at n = 1,024 with 2 words a thread). The thread that holds a slot
//     gathers it, its loads issued together, and writes it (8- or
//     16-byte stores);
//   * rank_wide (n > 1,024): the row is staged in shared memory where it
//     fits, by the threads' 16-byte loads in the pass that finds the keys'
//     span (a bulk asynchronous copy, then that pass over shared memory,
//     measured slower: PERF.md), else left in device memory; a radix select of DIGIT-bit passes from the highest
//     bit where the keys differ (two at 16,384 rows) finds the R-th
//     largest key thr and how many keys equal to it the top R takes
//     (k_eq); one ordered pass, WIDE_KEYS keys a thread, places the A = R
//     - k_eq keys above thr in a list by position and the positions of
//     the first k_eq keys equal to thr in the tail, in ascending
//     position (one barrier a pass step). Only the list is sorted: in
//     registers by the smallest unrolled block that holds it (its other
//     threads skip the sort) up to REG_SORT_MAX words, past that in
//     memory (shared where it fits, else the type row's own output rows
//     2-5 at slots below A, which no tail slot touches). Either sort
//     costs R log^2 R. An all-equal row (every padded type row) sorts
//     nothing. Then every slot, the sorted list's and the tail's, is
//     gathered and written, WIDE_PER a thread with their loads together.
// The gate word's load overlaps the row's: only writes wait on it.
//
// Included by both kernels' sources; kernels/build.py hashes it into both
// libraries' fingerprints, so an edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace rank_select {

using u64 = unsigned long long;

constexpr unsigned FULL = 0xffffffffu;
// the radix select's digit: DIGIT bits, BINS bins; lane l of a warp
// scans the PER_LANE bins from the top down that start at BINS - 1 -
// PER_LANE * l, held at l * HSTRIDE (padded: the lanes' reads of one step
// fall in distinct banks)
constexpr int DIGIT = 9;
constexpr int BINS = 1 << DIGIT;
constexpr int PER_LANE = BINS / 32;
constexpr int HSTRIDE = PER_LANE + 1;
constexpr int HIST = 32 * HSTRIDE;
// the whole-row regime: WHOLE_THREADS threads of WHOLE_PER words
constexpr int WHOLE_MAX = 1024;
constexpr int WHOLE_THREADS = 512;
constexpr int WHOLE_PER = WHOLE_MAX / WHOLE_THREADS;
// whole rows: sort 32-bit words where the row's key span leaves room for
// the position
constexpr bool PACK32 = true;
// the nine words of a slot (RankOut order)
constexpr int RANK_ROWS = 9;
struct Slot {
    int32_t w[RANK_ROWS];
};
// the wide regime: one block of WIDE_THREADS, WIDE_PER words a thread in
// the register sort of its list
constexpr int WIDE_THREADS = 1024;
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int WIDE_PER = 4;
constexpr int REG_SORT_MAX = WIDE_THREADS * WIDE_PER;
// a wide block's passes over the row take WIDE_KEYS consecutive keys a
// thread (16-byte loads), WIDE_CHUNK keys a pass step
constexpr int WIDE_KEYS = 4;
constexpr int WIDE_CHUNK = WIDE_THREADS * WIDE_KEYS;
// dynamic shared memory of a wide block: its list (or the register
// sort's exchange buffer), then the staged keys
constexpr size_t SMEM_BYTES = 200 * 1024;
constexpr size_t LIST_BYTES = 128 * 1024;
static_assert(WIDE_WARPS <= 32, "one lane a warp in the count scan");

__host__ __device__ __forceinline__ unsigned key_of(int v) { return (unsigned)v ^ 0x80000000u; }
__host__ __device__ __forceinline__ int val_of(unsigned k) { return (int)(k ^ 0x80000000u); }
__device__ __forceinline__ u64 word_of(unsigned u, int i)
{
    return ((u64)u << 32) | (unsigned)~(unsigned)i;
}
__device__ __forceinline__ int word_val(u64 w) { return val_of((unsigned)(w >> 32)); }
__device__ __forceinline__ int word_pos(u64 w) { return (int)~(unsigned)w; }

__host__ __device__ constexpr int log2_of(int p) { return p <= 1 ? 0 : 1 + log2_of(p / 2); }

__host__ __device__ __forceinline__ int pow2_at_least(int n)
{
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// A barrier among the first *count* threads of the block (a multiple of
// 32): barrier 1, which __syncthreads (barrier 0) never meets.
__device__ __forceinline__ void named_sync(int count)
{
    asm volatile("bar.sync 1, %0;" :: "r"(count) : "memory");
}

// A descending bitonic sort of P = THREADS * PER words, thread t holding
// words t * PER .. t * PER + PER - 1 in v. Every loop is unrolled at
// compile time (the network's shape, each step's partner and the
// in-thread directions are constants; a thread reads only its own bits at
// run time): steps within a thread run in registers, within a warp
// through shuffles, farther ones through buf (2P words of shared memory,
// its two halves in turn: one barrier a step). A word is taken from the
// partner where the partner is larger and this slot keeps the larger, or
// the reverse; the words are distinct, so ties never decide. PART: only
// the block's first THREADS threads call it (named_sync), else all.
template <int THREADS, int PER, class W, bool PART = false>
__device__ __forceinline__ void sort_block(W (&v)[PER], W* buf)
{
    constexpr int P = THREADS * PER;
    constexpr int LOG_P = log2_of(P), LOG_PER = log2_of(PER);
    const int base = threadIdx.x * PER;
    int half = 0;
#pragma unroll
    for (int lk = 1; lk <= LOG_P; ++lk) {
        const int k = 1 << lk;
#pragma unroll
        for (int lj = lk - 1; lj >= LOG_PER; --lj) {
            const int j = 1 << lj;
            const bool larger = ((base & k) == 0) == ((base & j) == 0);
            if (j >= 32 * PER) {
                W* s = buf + half;
                half ^= P;
#pragma unroll
                for (int e = 0; e < PER; ++e) s[base + e] = v[e];
                if (PART) named_sync(THREADS);
                else __syncthreads();
#pragma unroll
                for (int e = 0; e < PER; ++e) {
                    const W o = s[(base ^ j) + e];
                    v[e] = ((o > v[e]) == larger) ? o : v[e];
                }
            } else {
#pragma unroll
                for (int e = 0; e < PER; ++e) {
                    const W o = __shfl_xor_sync(FULL, v[e], j / PER);
                    v[e] = ((o > v[e]) == larger) ? o : v[e];
                }
            }
        }
#pragma unroll
        for (int lj = LOG_PER - 1; lj >= 0; --lj) {
            if (lj >= lk) continue;
            const int j = 1 << lj;
#pragma unroll
            for (int e = 0; e < PER; ++e) {
                if (e & j) continue;
                const bool desc = ((base + e) & k) == 0;
                const W a = v[e], b = v[e | j];
                const bool swap = (b > a) == desc;
                v[e] = swap ? b : a;
                v[e | j] = swap ? a : b;
            }
        }
    }
}

// The half of sort_block's buffer that no step of a THREADS x PER sort
// reads last (0 when no step uses the buffer): where its words may go.
template <int THREADS, int PER>
__host__ __device__ constexpr int sort_half()
{
    int half = 0;
    for (int lk = 1; (1 << lk) <= THREADS * PER; ++lk)
        for (int lj = lk - 1; (1 << lj) >= 32 * PER; --lj) half ^= THREADS * PER;
    return half;
}

// The same sort over P words held in memory (shared or device: *list*'s
// get and set), for lists past REG_SORT_MAX: one compare-exchange a pair,
// one barrier a step.
template <int THREADS, class List>
__device__ void sort_desc_mem(const List& list, int P)
{
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int q = threadIdx.x; q < P / 2; q += THREADS) {
                const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
                const int hi = lo | j;
                const u64 a = list.get(lo), b = list.get(hi);
                const bool desc = (lo & k) == 0;
                if (desc ? a < b : a > b) {
                    list.set(lo, b);
                    list.set(hi, a);
                }
            }
            __syncthreads();
        }
    }
}

// The list in shared memory.
struct SmemList {
    u64* w;
    __device__ __forceinline__ u64 get(int i) const { return w[i]; }
    __device__ __forceinline__ void set(int i, u64 x) const { w[i] = x; }
};

// The list in the type row's output rows (each R slots, *stride* apart):
// word i < A as rows 2 (key image) and 3 (position's complement) at slot
// i, word i >= A as rows 4 and 5 at slot i - A (< A, as P < 2A). Only
// slots below A, where the emit writes after the sort, are touched.
struct RowList {
    int32_t* row2;
    size_t stride;
    int A;
    __device__ __forceinline__ u64 get(int i) const
    {
        const int32_t* r = i < A ? row2 : row2 + 2 * stride;
        const int s = i < A ? i : i - A;
        return ((u64)(unsigned)r[s] << 32) | (unsigned)r[s + stride];
    }
    __device__ __forceinline__ void set(int i, u64 x) const
    {
        int32_t* r = i < A ? row2 : row2 + 2 * stride;
        const int s = i < A ? i : i - A;
        r[s] = (int32_t)(unsigned)(x >> 32);
        r[s + stride] = (int32_t)(unsigned)x;
    }
};

// PER words of a row from p[base ..] (p[i] for i < n, else 0): one
// 16-byte or 8-byte load a 4 or 2 words where they are whole and aligned.
template <int PER>
__device__ __forceinline__ void load_run(const int32_t* p, int base, int n, int (&out)[PER])
{
    const bool whole = base + PER <= n;
    if (PER % 4 == 0 && whole && (reinterpret_cast<uintptr_t>(p + base) & 15) == 0) {
#pragma unroll
        for (int c = 0; c < PER / 4; ++c) {
            const int4 q = reinterpret_cast<const int4*>(p + base)[c];
            out[4 * c] = q.x;
            out[4 * c + 1] = q.y;
            out[4 * c + 2] = q.z;
            out[4 * c + 3] = q.w;
        }
    } else if (PER == 2 && whole && (reinterpret_cast<uintptr_t>(p + base) & 7) == 0) {
        const int2 q = *reinterpret_cast<const int2*>(p + base);
        out[0] = q.x;
        out[PER - 1] = q.y;
    } else {
#pragma unroll
        for (int e = 0; e < PER; ++e) out[e] = base + e < n ? p[base + e] : 0;
    }
}

// Slots base .. base + PER - 1 of the nine rows of *out* (row r at out + r
// * TR, R slots a row): 16-byte or 8-byte stores where the run is whole
// and aligned, so a warp writes whole lines.
template <int PER>
__device__ __forceinline__ void store_slots(int32_t* out, size_t TR, int base, int R,
                                            const Slot (&s)[PER])
{
    const bool whole = base + PER <= R;
#pragma unroll
    for (int r = 0; r < RANK_ROWS; ++r) {
        int32_t* row = out + r * TR;
        if (PER % 4 == 0 && whole && (reinterpret_cast<uintptr_t>(row + base) & 15) == 0) {
#pragma unroll
            for (int c = 0; c < PER / 4; ++c)
                reinterpret_cast<int4*>(row + base)[c] = make_int4(
                    s[4 * c].w[r], s[4 * c + 1].w[r], s[4 * c + 2].w[r], s[4 * c + 3].w[r]);
        } else if (PER == 2 && whole && (reinterpret_cast<uintptr_t>(row + base) & 7) == 0) {
            *reinterpret_cast<int2*>(row + base) = make_int2(s[0].w[r], s[PER - 1].w[r]);
        } else {
#pragma unroll
            for (int e = 0; e < PER; ++e)
                if (base + e < R) row[base + e] = s[e].w[r];
        }
    }
}

// The block of a whole-row rank of n keys: the fewest threads (a power of
// two, one warp at least) whose WHOLE_PER words each hold the row; it
// sorts P = threads * WHOLE_PER words, zero past n.
__host__ __device__ __forceinline__ int whole_threads(int n)
{
    const int t = pow2_at_least(n) / WHOLE_PER;
    return t < 32 ? 32 : t;
}

// The whole-row regime: the top R of keys[0 .. n) (n <= THREADS * PER,
// the block whole_threads(n) picks). Each thread loads its PER keys; one
// barrier then gives the row's key span and whether it is sorted
// already; the sort runs on 32-bit words (key minus the smallest, above
// P - 1 - position) where the span leaves log2(P) bits, else on 64-bit
// ones; each thread then gathers the slots it holds, all loads issued
// together, and writes them. Where *open* is 0 nothing is written.
template <int THREADS, int PER, class Emit>
__device__ __forceinline__ void rank_whole(const int32_t* __restrict__ keys, int n,
                                           int R, int open, const Emit& emit)
{
    constexpr int WARPS = THREADS / 32;
    constexpr int P = THREADS * PER;
    constexpr int pbits = log2_of(P);
    __shared__ unsigned s_red[3][WARPS];
    __shared__ u64 xbuf[2 * P];  // the sort's exchange buffer
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int base = threadIdx.x * PER;
    int k[PER];
    load_run<PER>(keys, base, n, k);
    // the key after this thread's last: the sorted-row test's
    const int next = base + PER < n ? keys[base + PER] : 0;
    if (!open) return;
    unsigned lo = ~0u, hi = 0u;
    bool sorted = true;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
        if (base + e >= n) continue;
        const unsigned u = key_of(k[e]);
        lo = min(lo, u);
        hi = max(hi, u);
        // descending words: a larger key, or an equal one (its position lower)
        if (base + e + 1 < n)
            sorted &= u >= key_of(e + 1 < PER ? k[e + 1] : next);
    }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    sorted = __all_sync(FULL, sorted);
    if (lane == 0) {
        s_red[0][warp] = lo;
        s_red[1][warp] = hi;
        s_red[2][warp] = sorted;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        lo = min(lo, s_red[0][w]);
        hi = max(hi, s_red[1][w]);
        sorted &= s_red[2][w] != 0;
    }
    int key[PER], pos[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
        key[e] = k[e];
        pos[e] = base + e;
    }
    if (sorted) {
        // every word already in place (every key equal: a padded type row)
    } else if (PACK32 && ((hi - lo) >> (32 - pbits)) == 0u) {
        unsigned v[PER];
#pragma unroll
        for (int e = 0; e < PER; ++e)
            v[e] = base + e < n ? ((key_of(k[e]) - lo) << pbits) | (unsigned)(P - 1 - base - e)
                                : 0u;
        sort_block<THREADS, PER, unsigned>(v, reinterpret_cast<unsigned*>(xbuf));
#pragma unroll
        for (int e = 0; e < PER; ++e) {
            key[e] = val_of((v[e] >> pbits) + lo);
            pos[e] = P - 1 - (int)(v[e] & (unsigned)(P - 1));
        }
    } else {
        u64 v[PER];
#pragma unroll
        for (int e = 0; e < PER; ++e)
            v[e] = base + e < n ? word_of(key_of(k[e]), base + e) : 0ull;
        sort_block<THREADS, PER, u64>(v, xbuf);
#pragma unroll
        for (int e = 0; e < PER; ++e) {
            key[e] = word_val(v[e]);
            pos[e] = word_pos(v[e]);
        }
    }
    Slot slot[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e)
        if (base + e < R) slot[e] = emit.gather(key[e], pos[e]);
    store_slots<PER>(emit.out, emit.TR, base, R, slot);
}

// How a wide block lays out its dynamic shared memory (host and device):
// the list region, the tail's positions, then the staged keys.
struct WidePlan {
    int list_words;   // words of the list region: list, or exchange buffer
    int list_global;  // 1: the list lives in the output rows (RowList)
    int tail_smem;    // 1: the tail's positions in shared memory (else row 6)
    int stage;        // 1: the keys are staged after the tail
    size_t bytes;     // dynamic shared memory of the launch
};

__host__ __device__ __forceinline__ WidePlan wide_plan(int n, int R)
{
    const int pr = pow2_at_least(R);
    WidePlan p;
    if (pr <= REG_SORT_MAX) {          // list, then the sort's two halves in place
        p.list_words = 2 * pr;
        p.list_global = 0;
    } else if ((size_t)pr * sizeof(u64) <= LIST_BYTES) {
        p.list_words = pr;             // a list past REG_SORT_MAX: 2 P_A <= pr
        p.list_global = 0;             // when its own length fits the registers
    } else {
        p.list_words = 2 * REG_SORT_MAX;
        p.list_global = 1;
    }
    const size_t list = (size_t)p.list_words * sizeof(u64);
    const size_t tail = ((size_t)R * sizeof(int32_t) + 15) & ~(size_t)15;
    p.tail_smem = list + tail <= SMEM_BYTES;
    const size_t head = list + (p.tail_smem ? tail : 0);
    p.stage = head + (size_t)n * sizeof(int32_t) <= SMEM_BYTES;
    p.bytes = head + (p.stage ? (size_t)n * sizeof(int32_t) : 0);
    return p;
}

// The tail's positions: in shared memory, or in row 6 of the type row's
// output at the tail's own slots (A + e), which only the thread that
// emits slot A + e reads, before it writes it.
struct TailList {
    int32_t* w;
    __device__ __forceinline__ int get(int e) const { return w[e]; }
    __device__ __forceinline__ void set(int e, int pos) const { w[e] = pos; }
};

// Let *kernel* take up to *bytes* of dynamic shared memory on *device*,
// once per device (*ready*: a bit per device already set; past 64
// devices every call sets it).
template <class K>
inline cudaError_t allow_smem(K* kernel, int device, std::atomic<unsigned long long>& ready,
                              size_t bytes)
{
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (ready.load() & bit) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) ready.fetch_or(bit);
    return err;
}

// Add one key's bin to histogram h for each lane of a warp (bin BINS:
// none): the lanes whose bin is lane 0's add once through lane 0 (most
// of a sel row shares the val-0 bin), the others each alone: one
// predicated add a lane, no divergent branch.
__device__ __forceinline__ int hist_slot(unsigned bin)
{
    const int r = BINS - 1 - (int)bin;
    return r / PER_LANE * HSTRIDE + r % PER_LANE;
}

__device__ __forceinline__ void add_bin(int* h, unsigned bin, int lane)
{
    const unsigned b0 = __shfl_sync(FULL, bin, 0);
    const unsigned same = __ballot_sync(FULL, bin == b0);
    const bool lead = lane == 0;
    if (bin < BINS && (lead || bin != b0))
        atomicAdd(&h[hist_slot(bin)], lead ? __popc(same) : 1);
}

// The R-th largest of keys[0 .. n) as a key image, *thr*, and how many
// keys equal to it the top R takes, *k_eq* (1 <= k_eq <= R). *lo*, *hi*:
// the smallest and largest key images. Passes of DIGIT bits run from the
// highest bit where they differ down (a sel row of 16,384 nodes spans 18
// bits: two passes), the last one overlapping bits already fixed where
// the span is no multiple of DIGIT; none runs when every key is equal.
// Three histograms in turn, each warp scanning the current one itself:
// one barrier a pass. hist[0] is zero on entry.
template <int THREADS>
__device__ __forceinline__ void radix_select(const int32_t* keys, int n, int R,
                                             unsigned lo, unsigned hi,
                                             int (*hist)[HIST], unsigned& thr, int& k_eq)
{
    const int lane = threadIdx.x & 31;
    const unsigned differ = lo ^ hi;
    int k = R;  // the rank, from the top and 1-based, still to place
    if (differ == 0u) {
        thr = lo;
        k_eq = k;
        return;
    }
    const int high = 31 - __clz(differ);  // the highest differing bit
    int shift = high >= DIGIT - 1 ? high - (DIGIT - 1) : 0;
    unsigned mask = shift + DIGIT >= 32 ? 0u : ~0u << (shift + DIGIT);
    unsigned prefix = lo & mask;
    for (int p = 0;; ++p) {
        int* h = hist[p % 3];
        int* next = hist[(p + 1) % 3];
        for (int b = threadIdx.x; b < HIST; b += THREADS) next[b] = 0;
        for (int base = 0; base < n; base += THREADS * WIDE_KEYS) {
            const int i0 = base + threadIdx.x * WIDE_KEYS;
            int v[WIDE_KEYS];
            load_run<WIDE_KEYS>(keys, i0, n, v);
#pragma unroll
            for (int e = 0; e < WIDE_KEYS; ++e) {
                const unsigned u = key_of(v[e]);
                add_bin(h, i0 + e < n && (u & mask) == prefix ? (u >> shift) & (BINS - 1)
                                                             : (unsigned)BINS, lane);
            }
        }
        __syncthreads();
        // lane l holds bins BINS - 1 - PER_LANE * l downwards: an inclusive
        // scan over the lanes counts the keys from the top bin down
        int c[PER_LANE], s = 0;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
            c[j] = h[lane * HSTRIDE + j];  // bin BINS - 1 - PER_LANE * lane - j
            s += c[j];
        }
        int inc = s;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc += v;
        }
        int run = inc - s;
        const unsigned who = __ballot_sync(FULL, run < k && k <= inc);
        const int src = __ffs(who) - 1;
        int pick = 0, before = 0;
        if (lane == src) {
#pragma unroll
            for (int j = 0; j < PER_LANE; ++j) {
                if (run + c[j] >= k) {
                    pick = BINS - 1 - PER_LANE * lane - j;
                    before = run;
                    break;
                }
                run += c[j];
            }
        }
        pick = __shfl_sync(FULL, pick, src);
        before = __shfl_sync(FULL, before, src);
        prefix |= (unsigned)pick << shift;
        mask |= (unsigned)(BINS - 1) << shift;
        k -= before;
        if (shift == 0) break;
        shift = shift >= DIGIT ? shift - DIGIT : 0;
    }
    thr = prefix;
    k_eq = k;
}

// Sort the A (1 <= A <= REG_SORT_MAX) list words in registers by the
// smallest block of sort_block that holds them (WIDE_PER words a thread);
// returns where the sorted words went (sorted[j] the j-th largest).
template <class List>
__device__ __forceinline__ const u64* sort_list(const List& list, int A, u64* region)
{
    const int b = threadIdx.x * WIDE_PER;
    u64 v[WIDE_PER];
#pragma unroll
    for (int e = 0; e < WIDE_PER; ++e) v[e] = b + e < A ? list.get(b + e) : 0ull;
    // the exchange buffer is the region: a thread's writes to its first
    // half land on the words it has just read, and no word is read from
    // the second. Threads past the sort's block skip it.
    const int P = pow2_at_least(A);
    const int t = threadIdx.x;
    int half;
    if (P <= 32 * WIDE_PER) {
        if (t < 32) sort_block<32, WIDE_PER, u64, true>(v, region);
        half = sort_half<32, WIDE_PER>();
    } else if (P <= 64 * WIDE_PER) {
        if (t < 64) sort_block<64, WIDE_PER, u64, true>(v, region);
        half = sort_half<64, WIDE_PER>();
    } else if (P <= 128 * WIDE_PER) {
        if (t < 128) sort_block<128, WIDE_PER, u64, true>(v, region);
        half = sort_half<128, WIDE_PER>();
    } else if (P <= 256 * WIDE_PER) {
        if (t < 256) sort_block<256, WIDE_PER, u64, true>(v, region);
        half = sort_half<256, WIDE_PER>();
    } else if (P <= 512 * WIDE_PER) {
        if (t < 512) sort_block<512, WIDE_PER, u64, true>(v, region);
        half = sort_half<512, WIDE_PER>();
    } else {
        sort_block<1024, WIDE_PER, u64>(v, region);
        half = sort_half<1024, WIDE_PER>();
    }
    u64* sorted = region + half;
#pragma unroll
    for (int e = 0; e < WIDE_PER; ++e)
        if (b + e < A) sorted[b + e] = v[e];
    return sorted;
}

// The wide regime: the top R of g_keys[0 .. n) (n > WHOLE_MAX) under
// plan *wp*, each winner emitted. s_dyn: the block's dynamic shared
// memory; row2 and stride: the type row's output row 2 and the distance
// between rows (the scratch of a list or tail past shared memory). Where
// *open* is 0 nothing is written.
template <class Emit>
__device__ __forceinline__ void rank_wide(const int32_t* __restrict__ g_keys, int n, int R,
                                          int open, WidePlan wp, unsigned char* s_dyn,
                                          int32_t* row2, size_t stride, const Emit& emit)
{
    constexpr int THREADS = WIDE_THREADS;
    __shared__ int s_hist[3][HIST];
    __shared__ int s_warp[2][WIDE_WARPS];
    __shared__ unsigned s_span[2];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    u64* region = reinterpret_cast<u64*>(s_dyn);
    int32_t* s_tail = reinterpret_cast<int32_t*>(region + wp.list_words);
    int32_t* s_keys = s_tail + (wp.tail_smem ? ((R + 3) & ~3) : 0);
    if (tid == 0) {
        s_span[0] = ~0u;
        s_span[1] = 0u;
    }
    for (int b = tid; b < HIST; b += THREADS) s_hist[0][b] = 0;
    __syncthreads();
    unsigned lo = ~0u, hi = 0u;
    // the keys' span, staging them on the way
    for (int base = 0; base < n; base += WIDE_CHUNK) {
        const int i0 = base + tid * WIDE_KEYS;
        int v[WIDE_KEYS];
        load_run<WIDE_KEYS>(g_keys, i0, n, v);
#pragma unroll
        for (int e = 0; e < WIDE_KEYS; ++e) {
            if (i0 + e >= n) continue;
            if (wp.stage) s_keys[i0 + e] = v[e];
            const unsigned u = key_of(v[e]);
            lo = min(lo, u);
            hi = max(hi, u);
        }
    }
    const int32_t* keys = wp.stage ? s_keys : g_keys;
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    if (lane == 0) {
        atomicMin(&s_span[0], lo);
        atomicMax(&s_span[1], hi);
    }
    __syncthreads();  // also orders the staging loop's writes
    if (!open) return;
    unsigned thr;
    int k_eq;
    radix_select<THREADS>(keys, n, R, s_span[0], s_span[1], s_hist, thr, k_eq);
    const int A = R - k_eq;  // the keys above thr: every one a winner
    const SmemList slist{region};
    const RowList rlist{row2, stride, A};
    const TailList tail{wp.tail_smem ? s_tail : row2 + 4 * stride + A};

    // one ordered pass, WIDE_KEYS consecutive keys a thread: the keys above
    // thr into the list at their rank by position, the positions of the
    // first k_eq keys equal to thr into the tail in order. A key's rank:
    // those of earlier warps (two warp reductions over the warps' counts,
    // double-buffered: one barrier a step), of earlier lanes (a ballot a
    // key), and this thread's own earlier keys.
    const unsigned lt = (1u << lane) - 1u;
    int carry_ab = 0, carry_eq = 0;
    for (int base = 0, c = 0; base < n && (carry_ab < A || carry_eq < k_eq);
         base += WIDE_CHUNK, ++c) {
        const int i0 = base + tid * WIDE_KEYS;
        int v[WIDE_KEYS];
        load_run<WIDE_KEYS>(keys, i0, n, v);
        bool ab[WIDE_KEYS], eq[WIDE_KEYS];
        int lane_ab = 0, lane_eq = 0, warp_ab = 0, warp_eq = 0;
#pragma unroll
        for (int e = 0; e < WIDE_KEYS; ++e) {
            const unsigned u = key_of(v[e]);
            ab[e] = i0 + e < n && u > thr;
            eq[e] = i0 + e < n && u == thr;
            const unsigned abb = __ballot_sync(FULL, ab[e]), eqb = __ballot_sync(FULL, eq[e]);
            lane_ab += __popc(abb & lt);
            lane_eq += __popc(eqb & lt);
            warp_ab += __popc(abb);
            warp_eq += __popc(eqb);
        }
        int* sw = s_warp[c & 1];
        if (lane == 0) sw[warp] = warp_eq | (warp_ab << 16);
        __syncthreads();
        const unsigned cnt = lane < WIDE_WARPS ? (unsigned)sw[lane] : 0u;
        const unsigned before = __reduce_add_sync(FULL, lane < warp ? cnt : 0u);
        const unsigned total = __reduce_add_sync(FULL, cnt);
        int s_ab = carry_ab + (int)(before >> 16) + lane_ab;
        int s_eq = carry_eq + (int)(before & 0xffffu) + lane_eq;
#pragma unroll
        for (int e = 0; e < WIDE_KEYS; ++e) {
            if (ab[e]) {
                const u64 w = word_of(key_of(v[e]), i0 + e);
                if (wp.list_global) rlist.set(s_ab, w);
                else slist.set(s_ab, w);
                ++s_ab;
            }
            if (eq[e]) {
                if (s_eq < k_eq) tail.set(s_eq, i0 + e);
                ++s_eq;
            }
        }
        carry_ab += (int)(total >> 16);
        carry_eq += (int)(total & 0xffffu);
    }
    __syncthreads();  // the list and the tail are written

    // the list sorted: in registers up to REG_SORT_MAX words, else in memory
    const u64* sorted = nullptr;
    if (A > 0 && pow2_at_least(A) <= REG_SORT_MAX) {
        sorted = wp.list_global ? sort_list(rlist, A, region) : sort_list(slist, A, region);
        __syncthreads();
    } else if (A > 0) {
        const int P = pow2_at_least(A);
        for (int i = A + tid; i < P; i += THREADS) {
            if (wp.list_global) rlist.set(i, 0ull);
            else slist.set(i, 0ull);
        }
        __syncthreads();
        if (wp.list_global) sort_desc_mem<THREADS>(rlist, P);
        else sort_desc_mem<THREADS>(slist, P);
        if (!wp.list_global) sorted = region;
    }

    // every slot, WIDE_PER a thread at a time, their gathers issued
    // together: slot j < A the j-th sorted word, the rest the tail
    for (int j0 = tid; j0 < R; j0 += WIDE_PER * THREADS) {
        Slot slot[WIDE_PER];
#pragma unroll
        for (int q = 0; q < WIDE_PER; ++q) {
            const int j = j0 + q * THREADS;
            if (j >= R) continue;
            if (j < A) {
                const u64 w = sorted != nullptr ? sorted[j] : rlist.get(j);
                slot[q] = emit.gather(word_val(w), word_pos(w));
            } else {
                slot[q] = emit.gather(val_of(thr), tail.get(j - A));
            }
        }
#pragma unroll
        for (int q = 0; q < WIDE_PER; ++q) {
            const int j = j0 + q * THREADS;
            if (j < R) emit.write(j, slot[q]);
        }
    }
}

}  // namespace rank_select
