// Stream-v3k noise as int8 signed digit planes, for Hopper (sm_90a).
//
// Replaces the in-kernel v3k generation of the TPU kernel
// pvw_tpu/ops/pallas_modmat.py::_fused_scaled_noise_matmul (the "tfry" branch
// of _make_fold_body's _generate). It writes exactly
// pvw_tpu_torch/ops/tfry.py::v3k_noise_digit_planes(k0, k1, row_off, rows, cols,
// l, bound, col_off):
//
//   out[j*jr + dd, r, c] = digit dd of the v3k value at global row row_off + r,
//                          global column col_off + c, coefficient j
//
// (jr = 1: the value itself; jr = 2: the balanced digits d0 + 256*d1), the
// plane layout that csrc/fused_scaled_noise_matmul.cu reads as its noise input.
// ``masked`` writes zero planes on the global rows outside [lo, hi) and draws
// nothing there: the TPU kernel's ``masked`` form draws the same stream and
// zeroes those values (_make_fold_body's _store), so the rows inside are
// byte-equal to the unmasked planes.
// The Threefry rounds, the 96-bit reduction and the digit split are in
// threefry.cuh.
//
// Why a launch of its own and not generation inside the fused matmul's blocks:
// the TPU kernel draws a tile's noise once, at channel 0, and keeps it in VMEM
// while its sequential channel axis runs. The fused matmul on this card gives
// each block one channel, so generating there would redo every Threefry once
// per channel (16 to 272 times). Here each value is drawn once per product.
//
// What bounds it on an H100: 32-bit integer instructions. A value takes 1.5
// Threefry evaluations (20 rounds of add, rotate, xor and 5 key injections)
// and a 96-bit reduction, about 116 instructions; at the toy c2 shape (4096
// x 4096 x l = 8) that is 1.6e10, ~0.47 ms at the SMs' issue rate (132 x 128
// lanes x 1.98 GHz), against 0.04 ms for the 134 MB of planes written once.
// One thread draws the coefficient pair jjp of one (row, column): three
// evaluations give both coefficients; neighbouring threads take neighbouring
// columns, so each warp's store of a plane row is 32 contiguous bytes. No
// shared memory, 25-29 registers, no spills.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 128;                 // columns per block
constexpr int MAX_GRID_Y = 65535;

template <int JR>
__global__ void __launch_bounds__(THREADS)
v3k_noise_planes_kernel(uint32_t k0, uint32_t k1, uint32_t row_off, uint32_t col_off,
                        int rows, int cols, int half_l, int bound, int masked, int lo,
                        int hi, int8_t* __restrict__ out) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= cols) return;
  const uint32_t jjp = blockIdx.z;
  const uint32_t rng = 2u * (uint32_t)bound + 1u;
  const uint32_t c = col_off + (uint32_t)col;
  const uint32_t base = (c * (uint32_t)half_l + jjp) << 2;
  const size_t plane = (size_t)rows * cols;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint32_t g = row_off + (uint32_t)row;
    int32_t v[2] = {0, 0};
    if (!masked || ((int32_t)g >= lo && (int32_t)g < hi)) {   // int32 rows, as the TPU's
      uint32_t a0, a1, b0, b1, e0, e1;
      threefry2x32(k0, k1, g, base | 0u, a0, a1);
      threefry2x32(k0, k1, g, base | 1u, b0, b1);
      threefry2x32(k0, k1, g, base | 2u, e0, e1);
      v[0] = (int32_t)reduce96(a0, b0, e0, rng) - bound;
      v[1] = (int32_t)reduce96(a1, b1, e1, rng) - bound;
    }
    int8_t* o = out + (size_t)row * cols + col;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const size_t j = 2 * (size_t)jjp + p;
      if (JR == 1) {
        o[j * plane] = (int8_t)v[p];
      } else {
        int32_t d0, d1;
        digit_split(v[p], d0, d1);
        o[(2 * j) * plane] = (int8_t)d0;
        o[(2 * j + 1) * plane] = (int8_t)d1;
      }
    }
  }
}

}  // namespace

// Launches on ``stream`` and returns the first CUDA error (0 on success).
// out int8 [l*jr, rows, cols], contiguous; l even; jr 1 (bound <= 127) or 2
// (bound <= 32639); ``masked`` 1 zeroes the global rows outside [lo, hi).
extern "C" int pvw_v3k_noise_planes(uint32_t k0, uint32_t k1, uint32_t row_off,
                                    uint32_t col_off, int rows, int cols, int l, int jr,
                                    int bound, int masked, int lo, int hi, void* out,
                                    void* stream) {
  if (rows <= 0 || cols <= 0 || l <= 0 || l % 2 || l / 2 > 65535 || bound < 0 ||
      (jr == 1 && bound > 127) || (jr == 2 && bound > 32639) || (jr != 1 && jr != 2))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + THREADS - 1) / THREADS, rows < MAX_GRID_Y ? rows : MAX_GRID_Y,
                  l / 2);
  cudaStream_t s = (cudaStream_t)stream;
  int8_t* o = (int8_t*)out;
  if (jr == 1)
    v3k_noise_planes_kernel<1><<<grid, THREADS, 0, s>>>(k0, k1, row_off, col_off, rows,
                                                         cols, l / 2, bound, masked, lo, hi, o);
  else
    v3k_noise_planes_kernel<2><<<grid, THREADS, 0, s>>>(k0, k1, row_off, col_off, rows,
                                                         cols, l / 2, bound, masked, lo, hi, o);
  return (int)cudaGetLastError();
}
