// Kernel 2's operand layout: residues -> balanced signed digit planes, laid
// out k-packed, for Hopper (sm_90a).
//
// Stands in for the XLA digit split of the JAX package's kernel-2 entry
// (pvw_tpu/ops/pallas_modmat.py::matmul_channels_pallas, the ``digits``
// calls ahead of _fused_banded_matmul; no Pallas kernel). For residues
// x[ch, r, kk] (canonical, int64) it writes
//
//   out[ch, j, r, kk] = digit j of x[ch, r, kk]   (j < nd, kk < k; 0 to k_pad)
//
// int8 [CH, nd, rows, k_pad], k_pad = k rounded up to 16: the planes that
// kernel 2 (csrc/banded_matmul.cu) reads through TMA. The digits are the
// balanced base-256 ones of ops/u64.py::to_signed_digit_list (final carry
// dropped): byte j of (x + 0x8080..80) ^ 0x8080..80, as kernel 4 splits
// its scales. The rhs [CH, k, n] is read transposed (element strides
// given), so both operands come out k-contiguous.
//
// What bounds it on an H100: bytes, 8 read and nd written an element. At
// config 4's [272 ch, 1024 x 512] operands, nd = 8, that is 2.3 GB a
// operand, 0.68 ms at 3.35 TB/s; the plain-torch form (an int64 add and
// xor, then one strided byte copy) took 3.8 and 4.4 ms. A block stages a
// 64 x 64 tile of biased values in shared memory, read coalesced along
// whichever axis has unit stride, then each thread turns 16 neighbouring
// k values of one row into one 16-byte store a digit plane (byte
// transposes).

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int TR = 64, TK = 64;         // a block's tile: rows x k
constexpr int THREADS = TR * TK / 16;   // a thread: 16 k values of one row
constexpr uint64_t DIGIT_BIAS = 0x8080808080808080ull;

__global__ void __launch_bounds__(THREADS)
digit_planes_kernel(const int64_t* __restrict__ x, long long sc, long long sr, long long sk,
                    int8_t* __restrict__ out, int rows, int k, int k_pad, int nd) {
  __shared__ uint64_t tile[TR][TK + 1];
  const int r0 = blockIdx.y * TR, k0 = blockIdx.x * TK, ch = blockIdx.z;
  const int64_t* xc = x + (size_t)ch * sc;
  for (int e = threadIdx.x; e < TR * TK; e += THREADS) {
    const int r = sk == 1 ? e / TK : e % TR, kk = sk == 1 ? e % TK : e / TR;
    uint64_t v = 0;
    if (r0 + r < rows && k0 + kk < k) v = (uint64_t)xc[(r0 + r) * sr + (k0 + kk) * sk];
    tile[r][kk] = (v + DIGIT_BIAS) ^ DIGIT_BIAS;
  }
  __syncthreads();
  const int r = threadIdx.x / (TK / 16), c = threadIdx.x % (TK / 16);
  const int kk0 = k0 + 16 * c;
  if (r0 + r >= rows || kk0 >= k_pad) return;
  // word q of digit plane j: byte j of values 4q..4q+3
  uint32_t w[8][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t lo[4], hi[4], tl[4], th[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint64_t v = tile[r][16 * c + 4 * q + b];
      lo[b] = (uint32_t)v;
      hi[b] = (uint32_t)(v >> 32);
    }
    transpose_bytes(lo, tl);
    transpose_bytes(hi, th);
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j][q] = tl[j], w[j + 4][q] = th[j];
  }
  const size_t plane = (size_t)rows * k_pad;
  int8_t* o = out + (size_t)ch * nd * plane + (size_t)(r0 + r) * k_pad + kk0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < nd)
      *reinterpret_cast<uint4*>(o + j * plane) = make_uint4(w[j][0], w[j][1], w[j][2], w[j][3]);
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
// x int64 [ch, rows, k] at element strides (sc, sr, sk), canonical
// residues; out int8 [ch, nd, rows, k_pad] contiguous, 16-byte aligned,
// k_pad = k rounded up to 16 (its pads written zero).
extern "C" int pvw_digit_planes(const void* x, long long sc, long long sr, long long sk,
                                void* out, int ch, int rows, int k, int k_pad, int nd,
                                void* stream) {
  if (ch <= 0 || ch > 65535 || rows <= 0 || k <= 0 || nd < 1 || nd > 8 ||
      k_pad != (k + 15) / 16 * 16 || (rows + TR - 1) / TR > 65535 ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((k_pad + TK - 1) / TK, (rows + TR - 1) / TR, ch);
  digit_planes_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)x, sc, sr, sk, (int8_t*)out, rows, k, k_pad, nd);
  return (int)cudaGetLastError();
}
