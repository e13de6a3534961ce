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
// block). Its warps are specialised:
// - 8 tensor-core warps contract channel c (digit_mma.cuh's banded form,
//   mma.sync s8, each warp a 16 x 16 tile) and hand its nd int32 columns to
// - 4 epilogue warps through a double-buffered shared column buffer
//   [2][nd][64 x 32] int32, with named barriers (FULL and EMPTY per buffer);
//   the epilogue warps add the noise MAC, fold, add the encode and store
//   channel c while the tensor-core warps contract channel c + 1. This is the
//   Hopper form of the TPU kernel's parity-alternating column scratch.
// The tile's noise is put on chip once, before channel 0, and read by every
// channel: drawn in the block with the v3k counters of csrc/v3k_noise_planes.cu
// (global row = row_off + r, global column = col_off + c, counter
// ((c*(l/2) + jjp) << 2) | t, all mod 2^32; threefry.cuh), or copied from the
// input planes. So under v3k there is no generator launch and no round trip
// of the noise planes through device memory (134 MB at the toy c2 shape).
//
// What bounds it on an H100: the digit products, as for kernel 1 (9.35e12
// int8 MACs at config-4 c2, 9.45 ms at the int8 tensor-core peak; 1.72e12 at
// the toy c2 shape, 1.74 ms); the in-kernel v3k adds ~116 32-bit operations a
// noise value (0.47 ms at the toy c2 shape at the SMs' issue rate).
//
// The on-chip budget, bytes of dynamic shared memory a block (at most 227 KB):
//   column buffer  2 * nd * 64 * 32 * 4   = 16 KB * nd  (128 KB at nd = 8)
//   noise planes   l * jr * 64 * 32       = 2 KB * l * jr (32 KB at config 4,
//                                           l = 16, jr = 1; 64 KB at l*jr = 32)
//   staging        64 * 80 + nd * 16 * 160 = 5 KB + 2.5 KB * nd
//   noise table    32 * nd * 4
// 186 KB at config 4 (nd = 8, l = 16, jr = 1), 218 KB at l * jr = 32, the
// most the kernel takes (the launch refuses more). The digit planes are kept
// as int8 (l*jr bytes an element, at most the int16 values' 2l), so input
// planes of any int8 digits are kept exactly. One block an SM. The tile is
// 64 x 32 (2048 outputs, the column buffer's nd int32 each at most doubled):
// config-4 c2 has 16 x 32 = 512 tiles (3.9 waves on 132 SMs), c1 256 (1.9
// waves); the toy c2 shape 8192.
// The epilogue's column reads and the tensor-core warps' paired stores use a
// swizzled buffer (column ^ 8 * (row mod 4)), conflict-free without padding.
// Left for later: wgmma with TMA loads, prefetching the next channel's first
// step under the hand-off, a persistent grid.

#include <cstdint>
#include <cuda_runtime.h>

#include "digit_mma.cuh"
#include "threefry.cuh"

namespace {

using namespace digit_mma;

constexpr int TM = 64;                    // output rows of a block's tile
constexpr int TN = 32;                    // output columns
constexpr int TILE = TM * TN;
constexpr int TC_THREADS = 256;           // 8 tensor-core warps, 16 x 16 each
constexpr int EPI_THREADS = 128;          // 4 epilogue warps
constexpr int THREADS = TC_THREADS + EPI_THREADS;
constexpr int MAX_PLANES = 32;            // l * jr noise digit planes on chip
constexpr int MAX_ROWS = MAX_PLANES;      // noise MAC rows: l (values) or l * jr
constexpr int MAX_SMEM = 232448;          // a block's shared memory on an H100
static_assert(TILE % EPI_THREADS == 0, "whole rows per epilogue pass");

// named barriers (0 is __syncthreads): FULL / EMPTY of each column buffer,
// the epilogue warps, the tensor-core warps
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_EPI = 5, BAR_TC = 6;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// column buffer word of (row, col) in the tile: swizzled so that the paired
// fragment stores (rows g, columns 2t) and the epilogue's row reads are
// conflict-free
__device__ __forceinline__ int cidx(int row, int col) {
  return row * TN + (col ^ ((row & 3) << 3));
}

template <int ND>
constexpr int smem_bytes_fixed() {
  return 2 * ND * TILE * 4 + (BandedSmem<ND, TM, TN>::A_WORDS +
                              BandedSmem<ND, TM, TN>::B_WORDS + MAX_ROWS * ND) * 4;
}

template <int ND>
__global__ void __launch_bounds__(THREADS, 1)
fused_pipelined_matmul_kernel(const int8_t* __restrict__ lhs,
                              const int8_t* __restrict__ band,
                              const int64_t* __restrict__ tables,
                              const int32_t* __restrict__ ntab,
                              const int8_t* __restrict__ noise,
                              uint32_t k0, uint32_t k1, uint32_t row_off,
                              uint32_t col_off, int bound,
                              const int64_t* __restrict__ sc,
                              const int64_t* __restrict__ etab,
                              int64_t* __restrict__ out, int chs, int m, int n, int kd,
                              int l, int jr, int nrows, int vals, int encode32, int gen) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* cols = reinterpret_cast<int32_t*>(smem);                 // [2][ND][TILE]
  uint32_t* sA = reinterpret_cast<uint32_t*>(cols + 2 * ND * TILE);
  uint32_t* sB = sA + BandedSmem<ND, TM, TN>::A_WORDS;
  int32_t* sN = reinterpret_cast<int32_t*>(sB + BandedSmem<ND, TM, TN>::B_WORDS);
  int8_t* planes = reinterpret_cast<int8_t*>(sN + MAX_ROWS * ND);  // [l*jr][TILE]

  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const int tid = threadIdx.x;

  // the tile's noise digit planes, once for every channel (plane j*jr + dd
  // holds digit dd of coefficient j, as the input planes do)
  if (gen) {
    const int half_l = l / 2;
    const uint32_t rng = 2u * (uint32_t)bound + 1u;
    for (int i = tid; i < TILE * half_l; i += THREADS) {
      const int e = i % TILE, jjp = i / TILE;
      const int r = e / TN, c = e % TN;
      int32_t v[2] = {0, 0};
      if (m0 + r < m && n0 + c < n) {
        const uint32_t grow = row_off + (uint32_t)(m0 + r);
        const uint32_t gcol = col_off + (uint32_t)(n0 + c);
        const uint32_t base = (gcol * (uint32_t)half_l + (uint32_t)jjp) << 2;
        uint32_t a0, a1, b0, b1, e0, e1;
        threefry2x32(k0, k1, grow, base | 0u, a0, a1);
        threefry2x32(k0, k1, grow, base | 1u, b0, b1);
        threefry2x32(k0, k1, grow, base | 2u, e0, e1);
        v[0] = (int32_t)reduce96(a0, b0, e0, rng) - bound;
        v[1] = (int32_t)reduce96(a1, b1, e1, rng) - bound;
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
    for (int i = tid; i < l * jr * TILE; i += THREADS) {
      const int pl = i / TILE, e = i % TILE;
      const int r = e / TN, c = e % TN;
      planes[i] = m0 + r < m && n0 + c < n
                      ? noise[((size_t)pl * m + m0 + r) * n + n0 + c] : (int8_t)0;
    }
  }
  __syncthreads();

  if (tid < TC_THREADS) {
    // tensor-core warps: contract channel ch into column buffer ch % 2
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = warp % (TM / 16) * 16, wn = warp / (TM / 16) * 16;
    const bool vecA = kd % 16 == 0 && (reinterpret_cast<uintptr_t>(lhs) & 15) == 0;
    const bool vecB = n % 16 == 0 && (reinterpret_cast<uintptr_t>(band) & 15) == 0;
    const auto sync = [] { bar_sync(BAR_TC, TC_THREADS); };
    for (int ch = 0; ch < chs; ++ch) {
      int32_t acc[ND][2][4];
      zero_acc<ND>(acc);
      contract_banded<ND, TM, TN, TC_THREADS>(lhs + (size_t)ch * m * kd,
                                              band + (size_t)ch * ND * kd * n, m, n, kd,
                                              m0, n0, tid, vecA, vecB, sA, sB, acc, sync);
      const int buf = ch & 1;
      if (ch >= 2) bar_sync(BAR_EMPTY + buf, THREADS);  // the epilogue is done with it
      int32_t* C = cols + buf * ND * TILE;
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wm + g + 8 * h, col = wn + 8 * j + 2 * t;
            *reinterpret_cast<int2*>(&C[c * TILE + cidx(row, col)]) =
                make_int2(acc[c][j][2 * h], acc[c][j][2 * h + 1]);
          }
      bar_arrive(BAR_FULL + buf, THREADS);
    }
  } else {
    // epilogue warps: noise MAC, fold, encode and store of channel ch; a
    // warp takes one tile row at a time, a lane one column
    const int et = tid - TC_THREADS;
    const size_t plane = (size_t)m * n;
    for (int ch = 0; ch < chs; ++ch) {
      const int buf = ch & 1;
      bar_sync(BAR_EPI, EPI_THREADS);                    // the last channel's table read
      for (int i = et; i < nrows * ND; i += EPI_THREADS)
        sN[i] = ntab[(size_t)ch * nrows * ND + i];
      bar_sync(BAR_EPI, EPI_THREADS);
      const Fold fold(tables + (size_t)ch * TAB);
      const Encode encode(etab == nullptr ? nullptr : etab + (size_t)ch * 3);
      bar_sync(BAR_FULL + buf, THREADS);                 // channel ch's columns are in
      const int32_t* C = cols + buf * ND * TILE;
      for (int i = 0; i < TILE / EPI_THREADS; ++i) {
        const int idx = et + i * EPI_THREADS;
        const int r = idx / TN, c = idx % TN;
        const int row = m0 + r, col = n0 + c;
        if (row >= m || col >= n) continue;
        int32_t p[ND];
#pragma unroll
        for (int cc = 0; cc < ND; ++cc) p[cc] = C[cc * TILE + cidx(r, c)];
        // noise NTT into the columns: value rows (coefficient rr composed
        // from its jr digit planes, against the jr = 1 table) or digit rows
        for (int rr = 0; rr < nrows; ++rr) {
          int32_t v;
          if (vals) {
            v = planes[rr * jr * TILE + idx];
            if (jr == 2) v += 256 * (int32_t)planes[(rr * 2 + 1) * TILE + idx];
          } else {
            v = planes[rr * TILE + idx];
          }
#pragma unroll
          for (int cc = 0; cc < ND; ++cc) p[cc] += v * sN[rr * ND + cc];
        }
        const size_t o = (size_t)row * n + col;
        uint64_t res = fold(p);
        if (sc != nullptr) res = addmod(res, encode((uint64_t)sc[o], encode32, fold.q), fold.q);
        out[(size_t)ch * plane + o] = (int64_t)res;
      }
      if (ch + 2 < chs) bar_arrive(BAR_EMPTY + buf, THREADS);  // free for channel ch + 2
    }
  }
}

}  // namespace

// Launches on ``stream`` and returns the first CUDA error (0 on success).
// lhs int8 [ch, m, kd], band int8 [ch, nd, kd, n], tables int64 [ch, 8], ntab
// int32 [ch, nrows, nd], out int64 [ch, m, n], all contiguous. The noise:
// input planes ``noise`` int8 [l*jr, m, n], or with ``gen`` the v3k values of
// key (k0, k1) at bound ``bound`` from global row ``row_off`` and column
// ``col_off`` (l even), or neither (nrows = 0). nrows is l with ``vals`` (value
// rows), else l*jr. ``sc`` int64 [m, n] and ``etab`` int64 [ch, 3] are null
// without the encode.
extern "C" int pvw_fused_pipelined_matmul(
    const void* lhs, const void* band, const void* tables, const void* ntab,
    const void* noise, uint32_t k0, uint32_t k1, uint32_t row_off, uint32_t col_off,
    int bound, const void* sc, const void* etab, void* out, int ch, int m, int n,
    int kd, int nd, int l, int jr, int nrows, int vals, int encode32, int gen,
    void* stream) {
  const bool has_noise = gen || noise != nullptr;
  if (ch <= 0 || m <= 0 || n <= 0 || kd <= 0 || nd < 1 || nd > 8 ||
      (gen && noise != nullptr) || (sc == nullptr) != (etab == nullptr) ||
      (m + TM - 1) / TM > 65535)
    return (int)cudaErrorInvalidValue;
  if (has_noise &&
      (l <= 0 || (jr != 1 && jr != 2) || l * jr > MAX_PLANES ||
       nrows != (vals ? l : l * jr) || (gen && (l % 2 || bound < 0 ||
                                                bound > (jr == 1 ? 127 : 32639)))))
    return (int)cudaErrorInvalidValue;
  if (!has_noise && nrows != 0) return (int)cudaErrorInvalidValue;
  const int planes = has_noise ? l * jr : 0;
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  cudaStream_t s = (cudaStream_t)stream;
  const auto go = [&](auto kernel, int fixed) -> int {
    const int bytes = fixed + planes * TILE;
    if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, bytes, s>>>(
        (const int8_t*)lhs, (const int8_t*)band, (const int64_t*)tables,
        (const int32_t*)ntab, (const int8_t*)noise, k0, k1, row_off, col_off, bound,
        (const int64_t*)sc, (const int64_t*)etab, (int64_t*)out, ch, m, n, kd, l, jr,
        nrows, vals, encode32, gen);
    return (int)cudaGetLastError();
  };
  switch (nd) {
    case 1: return go(fused_pipelined_matmul_kernel<1>, smem_bytes_fixed<1>());
    case 2: return go(fused_pipelined_matmul_kernel<2>, smem_bytes_fixed<2>());
    case 3: return go(fused_pipelined_matmul_kernel<3>, smem_bytes_fixed<3>());
    case 4: return go(fused_pipelined_matmul_kernel<4>, smem_bytes_fixed<4>());
    case 5: return go(fused_pipelined_matmul_kernel<5>, smem_bytes_fixed<5>());
    case 6: return go(fused_pipelined_matmul_kernel<6>, smem_bytes_fixed<6>());
    case 7: return go(fused_pipelined_matmul_kernel<7>, smem_bytes_fixed<7>());
    default: return go(fused_pipelined_matmul_kernel<8>, smem_bytes_fixed<8>());
  }
}
