// spec_gate: the megaround's loop condition, decided on the card, for
// Hopper (sm_90a).
//
// Replaces the condition of the reference's claim loop (the cond of the
// lax.while_loop at nhd_tpu/solver/speculate.py:533-535) and the test that
// lets a bucket with no need skip its solve (the lax.cond at :286-289).
// It writes the control tensor every other kernel of an iteration reads:
//   total    = sum(need)                     (status[1:], all TT rows)
//   alive    = ctl[0] && status[0] && total > 0 && ctl[1] < iters
//   ctl[0]   = alive                         (sticky: 0 stays 0)
//   ctl[1]  += alive                         (the iterations used)
//   ctl[2+b] = alive && sum(need[offsets[b] .. offsets[b+1])) > 0
// and, where `handle` is not 0, sets that conditional handle of the graph
// it runs in to alive (cudaGraphSetConditional). status[0] is the progress
// flag spec_fill sets when an iteration took anything; spec_elect clears
// it. iters is the depth of the claim planes (spec_iters()).
//
// On one device the megaround is one CUDA graph (solver/speculate.py):
// one spec_gate before a WHILE node (kernels/graph_while.cu) and one at the
// end of the node's body, both with the node's handle, so the node runs
// exactly the passes the reference's lax.while_loop runs and no pass
// launches after the exit; ctl[1] counts them, and spec_apply writes claim
// row ctl[1] - 1. With handle 0 (the host loop's yardstick, the card's
// launch-by-launch trip, a mesh's shards) the same calls run a fixed trip:
// once alive is 0 every later kernel returns at once, the gate writes 0
// again and the count stays, so the claims, counts, need and node state
// are those of the loop that stopped.
//
// Bound: the launch. The work is one pass over TT + 1 words (TT below
// 1024 on the main path) and B + 2 words out, 0.0015 ms above an empty
// launch on an H100; the WHILE node's gain is the launches it removes
// after the exit, not this kernel's own time, so the design stays: one
// block; each thread sums the need of the rows t = threadIdx.x,
// + THREADS, ... into its bucket's 64-bit shared sum (buckets found by
// walking the B + 1 offsets, which only grow with t), one barrier, then
// thread 0 writes the control words and sets the handle. The sums are
// 64-bit, so no total of int32 needs overflows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) spec_gate_kernel(
    const int32_t* __restrict__ status,   // [TT + 1]: progress, need
    const int32_t* __restrict__ offsets,  // [B + 1]: first global row of each bucket
    int32_t* __restrict__ ctl,            // [B + 2]: alive, iterations, live per bucket
    int TT, int B, int iters, unsigned long long handle)
{
    extern __shared__ unsigned long long s_need[];  // [B] two's complement sums
    for (int b = threadIdx.x; b < B; b += THREADS) s_need[b] = 0ull;
    __syncthreads();
    int b = 0;
    long long acc = 0;
    for (int t = threadIdx.x; t < TT; t += THREADS) {
        int nb = b;
        while (nb < B - 1 && offsets[nb + 1] <= t) ++nb;
        if (nb != b) {
            if (acc != 0) atomicAdd(&s_need[b], (unsigned long long)acc);
            acc = 0;
            b = nb;
        }
        acc += status[1 + t];
    }
    if (acc != 0) atomicAdd(&s_need[b], (unsigned long long)acc);
    __syncthreads();
    if (threadIdx.x != 0) return;
    long long total = 0;
    for (int i = 0; i < B; ++i) total += (long long)s_need[i];
    const int alive = ctl[0] != 0 && status[0] != 0 && total > 0 && ctl[1] < iters;
    ctl[0] = alive;
    ctl[1] += alive;
    for (int i = 0; i < B; ++i) ctl[2 + i] = alive && (long long)s_need[i] > 0;
    if (handle != 0ull)
        cudaGraphSetConditional((cudaGraphConditionalHandle)handle, alive);
}

}  // namespace

extern "C" int nhd_spec_gate(
    const void* status, const void* offsets, void* ctl, int TT, int B,
    int iters, unsigned long long handle, int device, void* stream)
{
    if (TT < 1 || B < 1 || iters < 1
        || (size_t)B * sizeof(unsigned long long) > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    spec_gate_kernel<<<1, THREADS, (size_t)B * sizeof(unsigned long long),
                       (cudaStream_t)stream>>>(
        (const int32_t*)status, (const int32_t*)offsets, (int32_t*)ctl, TT, B,
        iters, handle);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_spec_gate_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
