// The fused scaled-digit modular matmul, pipelined across channels, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pvw_tpu/ops/pallas_modmat.py::_fused_pipelined_matmul
// (body _make_pipelined_body). It computes exactly what the banded form of
// csrc/fused_scaled_noise_matmul.cu computes, for the options the TPU
// kernel's pipelined body supports: the banded rhs, the noise NTT from input
// digit planes or from in-kernel stream-v3k noise, value or digit noise rows,
// and the 32- or 64-bit gadget encode:
//
//   out[ch, m, n] = ( sum_{c<nd} 2^(8c) * ( lhs[ch] . band[ch, c]
//                                           + sum_r noise_r[m, n] * ntab[ch, r, c] )
//                     + encode(sc[m, n]) * g[ch] ) mod q
//
// The design: one block owns a 64 x 32 output tile and walks all CH channels
// (the TPU kernel's sequential channel grid axis becomes a loop in the
// block), on the contraction of wgmma_digit.cuh: a producer warpgroup
// streams channel after channel through the TMA ring (cp.async.bulk.tensor
// of lhs [64 x 128] and the k-packed band's nd planes [nd x 32 x 128] a
// stage), the consumers contract each 32-byte k step with one
// wgmma.mma_async m64n(32*nd)k32 s8 x s8 -> s32, and the two consumer
// warpgroups take alternate channels in ping-pong: one runs channel c's
// epilogue (noise MAC, fold, encode, stores) from its registers while the
// other contracts channel c + 1. This is the Hopper form of the TPU kernel's
// parity-alternating column scratch, with no column buffer at all.
// The tile's noise is put on chip once, while the first stages stream in,
// and read by every channel: drawn by the consumers with the v3k counters of
// csrc/v3k_noise_planes.cu (global row = row_off + r, global column =
// col_off + c, counter ((c*(l/2) + jjp) << 2) | t, all mod 2^32;
// threefry.cuh), or copied from the input planes. So under v3k there is no
// generator launch and no round trip of the noise planes through device
// memory (134 MB at the toy c2 shape).
//
// What bounds it on an H100: the digit products, as for kernel 1 (9.35e12
// int8 MACs at config-4 c2, 9.45 ms at the int8 tensor-core peak; 1.72e12 at
// the toy c2 shape, 1.74 ms); the in-kernel v3k adds ~116 32-bit operations a
// noise value (0.47 ms at the toy c2 shape at the SMs' issue rate).
//
// The on-chip budget, bytes of dynamic shared memory a block (at most 227 KB):
//   ring           S * (8 KB + 4 KB * nd)  (S = 3 at config 4, 6 at the toy chain)
//   noise planes   l * jr * 64 * 32 = 2 KB * l * jr (32 KB at config 4, l = 16,
//                                                     jr = 1; 64 KB at l*jr = 32)
//   epilogue scratch  2 * 18 KB (each consumer's noise table and scalars,
//                     copied in with cp.async while it contracts)
//   alignment and barriers  1,152
// The digit planes are kept as int8 (l*jr bytes an element, at most the
// int16 values' 2l), so input planes of any int8 digits are kept exactly.
// One block an SM; config-4 c2 has 16 x 32 = 512 tiles (3.9 waves on 132
// SMs), the toy c2 shape 8192.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"
#include "wgmma_digit.cuh"

namespace {

using namespace wgmma_digit;

constexpr int MAX_PLANES = 32;            // l * jr noise digit planes on chip
constexpr int CONSUMERS = THREADS - 128;
constexpr int BAR_PLANES = 1;             // named barrier: the consumers, planes written
constexpr int SCRATCH = scratch_bytes(true);    // a consumer's, beside the ring

template <int ND>
__global__ void __launch_bounds__(THREADS, 1)
fused_pipelined_matmul_kernel(const __grid_constant__ CUtensorMap ma,
                              const __grid_constant__ CUtensorMap mb, Epilogue E,
                              const int8_t* __restrict__ noise, uint32_t k0, uint32_t k1,
                              uint32_t row_off, uint32_t col_off, int bound, int chs, int l,
                              int gen, int nk, int stages, int planes_bytes) {
  extern __shared__ uint8_t smem[];
  const Ring<ND> R(smem, stages, planes_bytes + 2 * SCRATCH);
  int8_t* planes = reinterpret_cast<int8_t*>(R.extra());   // [l*jr][TILE]
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  const int a0 = blockIdx.y * BM, b0 = blockIdx.x * BN;
  const auto tile = [&](int j, int& ch, int& ta, int& tb) { ch = j, ta = a0, tb = b0; };
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) produce(R, &ma, &mb, tile, chs, nk);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int ct = threadIdx.x - 128;       // consumer thread, 0..255
    const int m = E.m, n = E.n, jr = E.jr;
    // the tile's noise digit planes, once for every channel (plane j*jr + dd
    // holds digit dd of coefficient j, as the input planes do)
    if (gen) {
      const int half_l = l / 2;
      const uint32_t rng = 2u * (uint32_t)bound + 1u;
      for (int i = ct; i < TILE * half_l; i += CONSUMERS) {
        const int e = i % TILE, jjp = i / TILE;
        const int r = e / BN, c = e % BN;
        int32_t v[2] = {0, 0};
        if (a0 + r < m && b0 + c < n) {
          const uint32_t grow = row_off + (uint32_t)(a0 + r);
          const uint32_t gcol = col_off + (uint32_t)(b0 + c);
          const uint32_t base = (gcol * (uint32_t)half_l + (uint32_t)jjp) << 2;
          uint32_t x0, x1, y0, y1, z0, z1;
          threefry2x32(k0, k1, grow, base | 0u, x0, x1);
          threefry2x32(k0, k1, grow, base | 1u, y0, y1);
          threefry2x32(k0, k1, grow, base | 2u, z0, z1);
          v[0] = (int32_t)reduce96(x0, y0, z0, rng) - bound;
          v[1] = (int32_t)reduce96(x1, y1, z1, rng) - bound;
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int j = 2 * jjp + p;
          if (jr == 1) {
            planes[j * TILE + e] = (int8_t)v[p];
          } else {
            int32_t d0, d1;
            digit_split(v[p], d0, d1);
            planes[2 * j * TILE + e] = (int8_t)d0;
            planes[(2 * j + 1) * TILE + e] = (int8_t)d1;
          }
        }
      }
    } else if (noise != nullptr) {
      for (int i = ct; i < l * jr * TILE; i += CONSUMERS) {
        const int pl = i / TILE, e = i % TILE;
        const int r = e / BN, c = e % BN;
        planes[i] = a0 + r < m && b0 + c < n
                        ? noise[((size_t)pl * m + a0 + r) * n + b0 + c] : (int8_t)0;
      }
    }
    asm volatile("bar.sync %0, %1;" ::"n"(BAR_PLANES), "n"(CONSUMERS) : "memory");

    const int tl = threadIdx.x % 128;
    uint8_t* scratch = R.extra() + planes_bytes + (wg - 1) * SCRATCH;
    int32_t acc[16 * ND];
    for (int ch = wg - 1; ch < chs; ch += 2) {
      prefetch<ND, false, true>(E, planes, ch, a0, b0, tl, scratch);
      contract(acc, R, ch, nk, wg - 1, ch > 0, ch + 1 < chs, tl % 32 == 0);
      epilogue<ND, false, true>(acc, E, planes, ch, a0, b0, tl, scratch, BAR_EPI + wg - 1);
    }
  }
}

}  // namespace

// Launches on ``stream`` and returns a CUDA error code (0 on success; a
// failed tensor-map encode is cudaErrorInvalidValue). lhs int8 [ch, m, kd]
// (byte strides lhs_row, lhs_ch) and the band int8 [ch, nd, n, kd], k-packed
// (band_row, band_plane, band_ch): k contiguous, strides multiples of 16, a
// 16-byte aligned base. tables int64 [ch, 8], ntab int32 [ch, nrows, nd],
// out int64 [ch, m, n], contiguous. The noise: input planes ``noise`` int8
// [l*jr, m, n], or with ``gen`` the v3k values of key (k0, k1) at bound
// ``bound`` from global row ``row_off`` and column ``col_off`` (l even), or
// neither (nrows = 0). nrows is l with ``vals`` (value rows), else l*jr.
// ``sc`` int64 [m, n] and ``etab`` int64 [ch, 3] are null without the encode.
extern "C" int pvw_fused_pipelined_matmul(
    const void* lhs, long long lhs_row, long long lhs_ch, const void* band,
    long long band_row, long long band_plane, long long band_ch, const void* tables,
    const void* ntab, const void* noise, uint32_t k0, uint32_t k1, uint32_t row_off,
    uint32_t col_off, int bound, const void* sc, const void* etab, void* out, int ch, int m,
    int n, int kd, int nd, int l, int jr, int nrows, int vals, int encode32, int gen,
    void* stream) {
  const bool has_noise = gen || noise != nullptr;
  if (ch <= 0 || m <= 0 || n <= 0 || kd <= 0 || nd < 1 || nd > 8 ||
      (gen && noise != nullptr) || (sc == nullptr) != (etab == nullptr) ||
      (m + BM - 1) / BM > 65535 || (long long)m * n > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  if (has_noise &&
      (l <= 0 || (jr != 1 && jr != 2) || l * jr > MAX_PLANES ||
       nrows != (vals ? l : l * jr) || (gen && (l % 2 || bound < 0 ||
                                                bound > (jr == 1 ? 127 : 32639)))))
    return (int)cudaErrorInvalidValue;
  if (!has_noise && nrows != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (const int err = make_maps(&ma, &mb, Operand{lhs, lhs_row, 0, lhs_ch},
                                Operand{band, band_row, band_plane, band_ch}, ch, m, n, kd, nd))
    return err;
  const int planes_bytes = has_noise ? l * jr * TILE : 0;
  const Epilogue E{(const int64_t*)tables, (const int32_t*)ntab, (const int64_t*)sc,
                   (const int64_t*)etab, nullptr, (int64_t*)out, m, n, nrows,
                   has_noise ? jr : 1, vals, encode32, Mask{0, 0, 0, 0}};
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const int nk = (kd + KT - 1) / KT;
  cudaStream_t s = (cudaStream_t)stream;
  const auto go = [&](auto kernel, int stages, int bytes) -> int {
    if (stages == 0) return (int)cudaErrorInvalidValue;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, THREADS, bytes, s>>>(ma, mb, E, (const int8_t*)noise, k0, k1, row_off,
                                        col_off, bound, ch, l, gen, nk, stages, planes_bytes);
    return (int)cudaGetLastError();
  };
  const int extra = planes_bytes + 2 * SCRATCH;
#define PVW_GO(ND)                                                                   \
  case ND:                                                                           \
    return go(fused_pipelined_matmul_kernel<ND>, ring_stages<ND>(extra),            \
              smem_bytes<ND>(ring_stages<ND>(extra), extra));
  switch (nd) {
    PVW_GO(1) PVW_GO(2) PVW_GO(3) PVW_GO(4) PVW_GO(5) PVW_GO(6) PVW_GO(7)
    default: PVW_GO(8)
  }
#undef PVW_GO
}
