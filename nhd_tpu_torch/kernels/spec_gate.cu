// spec_gate: the megaround's loop condition, decided on the card, for
// Hopper (sm_90a).
//
// Replaces the condition of the reference's claim loop (the cond of the
// lax.while_loop at nhd_tpu/solver/speculate.py:533-535) and the test that
// lets a bucket with no need skip its solve (the lax.cond at :286-289).
// The port runs the loop as a fixed trip of spec_iters() iterations inside
// one CUDA graph (solver/speculate.py); this kernel opens each iteration
// and writes the control tensor every other kernel of the iteration reads:
//   total    = sum(need)                     (status[1:], all TT rows)
//   alive    = ctl[0] && status[0] && total > 0
//   ctl[0]   = alive                         (sticky: 0 stays 0)
//   ctl[1]  += alive                         (the iterations used)
//   ctl[2+b] = alive && sum(need[offsets[b] .. offsets[b+1])) > 0
// status[0] is the progress flag spec_fill sets when an iteration took
// anything; spec_elect clears it, so the gate runs before spec_elect.
// Once alive is 0 nothing changes any more: every later kernel of the
// trip returns at once, the gate writes 0 again and the count stays. So
// the claims, counts, need and node state of the fixed trip are those of
// a loop that stops where the reference's stops, and ctl[1] is its
// iteration count.
//
// Bound: the launch. The work is one pass over TT + 1 words (TT below
// 1024 on the main path) and B + 2 words out. One block: each thread sums
// the need of the rows t = threadIdx.x, + THREADS, ... into its bucket's
// 64-bit shared sum (buckets found by walking the B + 1 offsets, which
// only grow with t), one barrier, then thread 0 writes the control words.
// The sums are 64-bit, so no total of int32 needs overflows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) spec_gate_kernel(
    const int32_t* __restrict__ status,   // [TT + 1]: progress, need
    const int32_t* __restrict__ offsets,  // [B + 1]: first global row of each bucket
    int32_t* __restrict__ ctl,            // [B + 2]: alive, iterations, live per bucket
    int TT, int B)
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
    const int alive = ctl[0] != 0 && status[0] != 0 && total > 0;
    ctl[0] = alive;
    ctl[1] += alive;
    for (int i = 0; i < B; ++i) ctl[2 + i] = alive && (long long)s_need[i] > 0;
}

}  // namespace

extern "C" int nhd_spec_gate(
    const void* status, const void* offsets, void* ctl, int TT, int B,
    int device, void* stream)
{
    if (TT < 1 || B < 1 || (size_t)B * sizeof(unsigned long long) > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    spec_gate_kernel<<<1, THREADS, (size_t)B * sizeof(unsigned long long),
                       (cudaStream_t)stream>>>(
        (const int32_t*)status, (const int32_t*)offsets, (int32_t*)ctl, TT, B);
    return (int)cudaGetLastError();
}

extern "C" const char* nhd_spec_gate_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
