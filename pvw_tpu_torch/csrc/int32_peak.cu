// The int32 multiply-add peak of the CUDA cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/fold_roofline.py::vpu_peak_kernel,
// which measured the VPU's int32 rate. For every element v of x (int32) it
// computes, in int32 wrap-around arithmetic, the TPU kernel's function:
//
//   acc_a = v + a                                      (a < lanes chains)
//   acc_a += v * (2 * (i * lanes + a) + 1)            (i < iters / lanes)
//   out   = acc_0 + ... + acc_{lanes-1}
//
// What bounds it: the integer multiply-adds, nothing else (8 bytes an
// element). Each is one IMAD, which Hopper issues on its FMA pipes: at most
// 64 a clock on an SM, 132 SMs x 64 x 1.98 GHz = 1.67e13 a second on an H100
// SXM at its boost clock.
//
// The design keeps the compiler from measuring nothing: written in C, the
// multiply-adds of one chain fold into one product (sum of the constants
// times v). So each is a ``mad.lo.s32`` in asm volatile, in blocks of MADS
// with immediate constants: the constant of step i of chain a splits as
// 2 * (i * lanes + a) + 1 = 2 * i0 * lanes + (2 * k + 1), i0 the block's
// first step and k < MADS the index of the multiply-add in the block, so a
// block is MADS immediate IMADs plus one IMAD a chain by the sum of its
// steps' first terms (STEPS * 2 * i0 * lanes, in a register); the steps
// past the last whole block take register constants. The ``lanes`` chains
// are independent, so each thread keeps ``lanes`` multiply-adds in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MADS = 256;               // immediate multiply-adds a block

__device__ __forceinline__ void mad(uint32_t& acc, uint32_t v, uint32_t c) {
  asm volatile("mad.lo.s32 %0, %1, %2, %0;" : "+r"(acc) : "r"(v), "r"(c));
}

// multiply-adds K0 .. K0 + N - 1 of a block, in order: K on chain K % LANES
// by the immediate 2K + 1 (split in halves: the template depth stays log N)
template <int LANES, int K0 = 0, int N = MADS>
__device__ __forceinline__ void mad_block(uint32_t (&acc)[LANES], uint32_t v) {
  if constexpr (N == 1) {
    asm volatile("mad.lo.s32 %0, %1, %2, %0;" : "+r"(acc[K0 % LANES]) : "r"(v), "n"(2 * K0 + 1));
  } else {
    mad_block<LANES, K0, N / 2>(acc, v);
    mad_block<LANES, K0 + N / 2, N - N / 2>(acc, v);
  }
}

template <int LANES>
__global__ void __launch_bounds__(THREADS)
int32_peak_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long count,
                  int iters) {
  constexpr int STEPS = MADS / LANES;   // steps of every chain a block
  const int steps = iters / LANES, blocks = steps / STEPS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < count;
       e += (long long)gridDim.x * THREADS) {
    const uint32_t v = (uint32_t)x[e];
    uint32_t acc[LANES];
#pragma unroll
    for (int a = 0; a < LANES; ++a) acc[a] = v + (uint32_t)a;
    uint32_t base = 0;                  // STEPS * 2 * i0 * lanes of the block
#pragma unroll 1
    for (int b = 0; b < blocks; ++b) {
#pragma unroll
      for (int a = 0; a < LANES; ++a) mad(acc[a], v, base);
      mad_block<LANES>(acc, v);
      base += 2u * STEPS * MADS;
    }
#pragma unroll 1
    for (int i = blocks * STEPS; i < steps; ++i)
#pragma unroll
      for (int a = 0; a < LANES; ++a) mad(acc[a], v, 2u * (uint32_t)(i * LANES + a) + 1u);
    uint32_t s = acc[0];
#pragma unroll
    for (int a = 1; a < LANES; ++a) s += acc[a];
    out[e] = (int32_t)s;
  }
}

}  // namespace

// x, out int32 [count], contiguous; lanes 1, 2, 4 or 8; iters >= 0. Launches
// on ``stream``; returns a CUDA error code (0 on success).
extern "C" int pvw_int32_peak(const void* x, void* out, long long count, int iters, int lanes,
                              void* stream) {
  if (count <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = (count + THREADS - 1) / THREADS;
  const int grid = (int)(need < 64LL * sms ? need : 64LL * sms);
  cudaStream_t s = (cudaStream_t)stream;
  const auto xi = (const int32_t*)x;
  const auto o = (int32_t*)out;
  switch (lanes) {
    case 1: int32_peak_kernel<1><<<grid, THREADS, 0, s>>>(xi, o, count, iters); break;
    case 2: int32_peak_kernel<2><<<grid, THREADS, 0, s>>>(xi, o, count, iters); break;
    case 4: int32_peak_kernel<4><<<grid, THREADS, 0, s>>>(xi, o, count, iters); break;
    case 8: int32_peak_kernel<8><<<grid, THREADS, 0, s>>>(xi, o, count, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
