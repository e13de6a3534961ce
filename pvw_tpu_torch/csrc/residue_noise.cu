// Row-keyed uniform noise ("stream v2") as NTT-domain residues, for Hopper
// (sm_90a): the noise of products whose bound has no signed digits (> 32639).
//
// Replaces no TPU kernel: the JAX package leaves this noise to XLA
// (pvw_tpu/sampling/uniform.py::sample_uniform_residues_rows, then
// pvw_tpu/ops/ntt.py::ntt_forward). It writes exactly the plain composition
// pvw_tpu_torch/ops/fused_modmat.py::residue_noise_ch_plain:
//
//   out[i, j, r, c] = sum_t x_i[t] * psi_i^(t*(2j+1))  mod q_i,
//   x_i[t] = (v[t] - bound) mod q_i,  v[t] = value t of (global row row_off + r, column c)
//
// channel-major [L, l, rows, cols], the layout of kernel 1's ``post`` input
// (csrc/fused_scaled_noise_matmul.cu), canonical residues. The values follow
// JAX's key semantics: row g's key is fold_in(key, g) = Threefry(key, (0, g));
// word f of that key's stream is y0 ^ y1 of Threefry(rowkey, (f >> 32, f mod
// 2^32)), f = (c*l + t)*W + w; a value is floor(X * range / 2^(32W)) of the W
// words X (most significant first), range = 2*bound + 1, W = 3 below a range
// of 2^30 (the 96-bit reduction of threefry.cuh) and W = 4 above it (the
// 128-bit construction of sampling/uniform.py::_bounded_from_words).
//
// What bounds it on an H100: 32-bit integer instructions. At the c2 shape of
// the reference's 128-bit set (1024 receivers x 1024 dealers, l = 8, 4 limbs,
// W = 3) a (row, column) takes 25 Threefry-2x32-20 evaluations and, per limb,
// the dense 8 x 8 forward NTT as 64 native 64-bit Shoup products: about 7.6e3
// instructions, 8e9 in all (0.24 ms at the SMs' issue rate), against 268 MB
// of residues written once (0.08 ms at 3.35 TB/s). The plain composition
// writes every intermediate to HBM in int64 (the words, the values, the
// residues expanded to L limbs, the NTT's digit columns): here a thread owns
// one (row, column), draws its l values, centres them, runs the NTT of each
// limb in registers and stores only the residues; neighbouring threads take
// neighbouring columns, so each warp's store of a (limb, slot) plane row is
// 256 contiguous bytes. The row key is recomputed by every thread of the row
// (one evaluation in 25 at l = 8): no shared memory, no synchronisation. The
// twiddles and their Shoup companions ([L, l, l, 2] uint64, 4 KB at the
// reference's ring) are read from global memory at addresses uniform across
// a warp, so each load is one broadcast from L1.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 128;                 // columns per block
constexpr int MAX_GRID_Y = 65535;

// Word f of the stream of key (k0, k1): JAX's ``bits`` (threefry, partitionable).
__device__ __forceinline__ uint64_t stream_word(uint32_t k0, uint32_t k1, uint64_t f) {
  uint32_t y0, y1;
  threefry2x32(k0, k1, (uint32_t)(f >> 32), (uint32_t)f, y0, y1);
  return (uint64_t)(y0 ^ y1);
}

// floor(X * rng / 2^128) for X = (w0, w1, w2, w3), rng < 2^63: the high word
// of xh * rng plus the carry out of its low word + the high word of xl * rng.
__device__ __forceinline__ uint64_t reduce128(uint64_t xh, uint64_t xl, uint64_t rng) {
  const uint64_t lo = xh * rng;
  const uint64_t s = lo + __umul64hi(xl, rng);
  return __umul64hi(xh, rng) + (s < lo ? 1u : 0u);
}

template <int DEG, int W>
__global__ void __launch_bounds__(THREADS)
residue_noise_kernel(uint32_t k0, uint32_t k1, uint32_t row_off, int rows, int cols,
                     int limbs, uint64_t bound, const uint64_t* __restrict__ q,
                     const uint64_t* __restrict__ tw, uint64_t* __restrict__ out) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= cols) return;
  const uint64_t rng = 2 * bound + 1;
  const size_t plane = (size_t)rows * cols;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    uint32_t r0, r1;
    threefry2x32(k0, k1, 0u, row_off + (uint32_t)row, r0, r1);   // fold_in(key, g)
    int64_t s[DEG];                                              // centred values
    const uint64_t f0 = (uint64_t)col * DEG * W;
#pragma unroll
    for (int t = 0; t < DEG; ++t) {
      const uint64_t f = f0 + (uint64_t)t * W;
      uint64_t v;
      if (W == 3) {
        v = reduce96((uint32_t)stream_word(r0, r1, f), (uint32_t)stream_word(r0, r1, f + 1),
                     (uint32_t)stream_word(r0, r1, f + 2), (uint32_t)rng);
      } else {
        const uint64_t xh = stream_word(r0, r1, f) << 32 | stream_word(r0, r1, f + 1);
        const uint64_t xl = stream_word(r0, r1, f + 2) << 32 | stream_word(r0, r1, f + 3);
        v = reduce128(xh, xl, rng);
      }
      s[t] = (int64_t)v - (int64_t)bound;
    }
    uint64_t* o = out + (size_t)row * cols + col;
    for (int i = 0; i < limbs; ++i) {
      const uint64_t qi = q[i];
      uint64_t x[DEG];
#pragma unroll
      for (int t = 0; t < DEG; ++t) x[t] = (uint64_t)(s[t] < 0 ? s[t] + (int64_t)qi : s[t]);
      const uint64_t* w = tw + (size_t)i * DEG * DEG * 2;
      for (int j = 0; j < DEG; ++j) {
        uint64_t acc = 0;
#pragma unroll
        for (int t = 0; t < DEG; ++t)
          acc = addmod(acc, shoup(x[t], w[2 * (j * DEG + t)], w[2 * (j * DEG + t) + 1], qi), qi);
        o[((size_t)i * DEG + j) * plane] = acc;
      }
    }
  }
}

template <int W>
void launch(int l, dim3 grid, cudaStream_t s, uint32_t k0, uint32_t k1, uint32_t row_off,
            int rows, int cols, int limbs, uint64_t bound, const uint64_t* q,
            const uint64_t* tw, uint64_t* out) {
  switch (l) {
    case 8:
      residue_noise_kernel<8, W><<<grid, THREADS, 0, s>>>(k0, k1, row_off, rows, cols, limbs,
                                                          bound, q, tw, out);
      break;
    case 16:
      residue_noise_kernel<16, W><<<grid, THREADS, 0, s>>>(k0, k1, row_off, rows, cols, limbs,
                                                           bound, q, tw, out);
      break;
    case 32:
      residue_noise_kernel<32, W><<<grid, THREADS, 0, s>>>(k0, k1, row_off, rows, cols, limbs,
                                                           bound, q, tw, out);
      break;
    default:
      residue_noise_kernel<64, W><<<grid, THREADS, 0, s>>>(k0, k1, row_off, rows, cols, limbs,
                                                           bound, q, tw, out);
  }
}

}  // namespace

// Launches on ``stream`` and returns the first CUDA error (0 on success).
// q int64 [limbs] (the moduli, each < 2^62); tw int64 [limbs, l, l, 2], entry
// (i, j, t) = (psi_i^(t*(2j+1)) mod q_i, its Shoup companion floor(w * 2^64 / q_i));
// out int64 [limbs, l, rows, cols], contiguous; l in {8, 16, 32, 64};
// 0 < bound < min q_i.
extern "C" int pvw_residue_noise(uint32_t k0, uint32_t k1, uint32_t row_off, int rows,
                                 int cols, int l, int limbs, uint64_t bound, const void* q,
                                 const void* tw, void* out, void* stream) {
  if (rows <= 0 || cols <= 0 || limbs <= 0 || bound == 0 || bound >= (1ull << 62) ||
      (l != 8 && l != 16 && l != 32 && l != 64))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + THREADS - 1) / THREADS, rows < MAX_GRID_Y ? rows : MAX_GRID_Y);
  cudaStream_t s = (cudaStream_t)stream;
  const uint64_t* qp = (const uint64_t*)q;
  const uint64_t* twp = (const uint64_t*)tw;
  uint64_t* o = (uint64_t*)out;
  if (2 * bound + 1 < (1ull << 30))
    launch<3>(l, grid, s, k0, k1, row_off, rows, cols, limbs, bound, qp, twp, o);
  else
    launch<4>(l, grid, s, k0, k1, row_off, rows, cols, limbs, bound, qp, twp, o);
  return (int)cudaGetLastError();
}
