// Fused scaled-digit modular matmul with the noise NTT and the gadget
// encode in its epilogue, for Hopper (sm_90a), in two operand forms.
//
// Replaces the TPU kernel pvw_tpu/ops/pallas_modmat.py::
// _fused_scaled_noise_matmul (body _make_fold_body), its banded form and its
// ``swapped`` variant (:696). Per channel ch of L*l (limb i, NTT slot s) it
// computes, canonical in [0, q_i):
//
//   out[ch, m, n] = ( sum_{c<nd} 2^(8c) * ( P_c[m, n]
//                                           + sum_r noise_r[m, n] * ntab[ch, r, c] )
//                     + post[ch, m, n] + encode(sc[m, n]) * g[ch] ) mod q
//
// with the nd int32 columns P_c of digit_mma.cuh:
// - banded: lhs int8 [CH, m, kd] and band int8 [CH, nd, kd, n] are balanced
//   digit planes (kd = k*nd); the band carries the 2^(8i) scales,
//   P_c = lhs . band[c];
// - swapped: the scales live on the cached lhs, lhs int8 [CH, nd, m, kd] of
//   digit_c(A*2^(8i) mod q) planes, and the rhs is the plain digits of r,
//   laid out k-packed by the wrapper, int8 [CH, n, kd]; P_c = lhs[c] . rhs.
//   Same columns, same fold, the same residues.
// The noise rows add the NTT of the error straight into those columns (ntab =
// digits of the scaled twiddles). ``post`` (the TPU kernel's ``has_post``) is
// a residue tensor added after the fold. The ``masked`` form (the TPU kernel's
// ``masked``, the kdim-split mesh shards' row contract) adds the encode only
// on the global rows row_off + row in [lo, hi); its noise is drawn ahead of
// the launch with the rows outside the range zeroed (csrc/v3k_noise_planes.cu),
// so the kernel needs the range for the encode alone. Every output is the
// canonical residue, so any exact arithmetic gives the same bytes as the TPU
// kernel.
//
// What bounds it on an H100: the digit products. At the config-4 c2 shape
// (CH = 272, m = n = 1024, kd = 4096, nd = 8) they are 9.35e12 int8 MACs,
// 9.45 ms at the int8 tensor-core peak (1,979 TOPS, 2 ops a MAC); the bytes
// it must move (the int8 inputs, the int64 output of 2.3 GB) take 3.75 ms at
// 3.35 TB/s (the swapped lhs is 9.1 GB there, 5.2 ms). So the bound is
// compute, and the contraction runs on the tensor cores: mma.sync m16n8k32
// s8 x s8 -> s32.
//
// The design: one block of 16 warps per (channel, output tile); each warp
// owns a 16 x 16 tile and keeps nd x 2 accumulator fragments (64 registers at
// nd = 8). The contraction is staged in steps of 64 bytes (digit_mma.cuh).
// The tile is 128 x 32 in the banded form and 32 x 128 in the swapped form:
// the operand that carries the nd planes (the band, or the swapped lhs) is
// the one re-read from L2 for each tile of the other dimension, so the tile is
// long along that operand's free axis; with it the swapped form's nd lhs
// tiles and its one rhs tile take the same ~30 KB of static shared memory as
// the banded form's tiles, and both read the same 402 MB a channel from L2 at
// config-4 c2. The epilogue adds the noise NTT to the int32 columns and folds
// them with native 64-bit Shoup multiplies (the TPU kernel's u32-pair fold
// exists only because the TPU lacks 64-bit integers). The grid walks the n
// tiles fastest and the channel slowest, so the blocks in flight share one
// channel's operands in L2.
// Left for later: wgmma with TMA loads and a multi-stage ring, a band laid
// out k-packed by its producer (no transposing here), and overlap of the
// epilogue with the next tile (csrc/fused_pipelined_matmul.cu overlaps it
// with the next channel).

#include <cstdint>
#include <cuda_runtime.h>

#include "digit_mma.cuh"

namespace {

using namespace digit_mma;

constexpr int MAX_ROWS = 64;   // noise MAC rows: l * jr <= 32 * 2

// The masked form's global row range: row r of the output is global row
// row_off + r (int32, as the TPU kernel's iota); ``on`` 0 keeps every row.
struct Mask {
  int on, row_off, lo, hi;
  __device__ __forceinline__ bool keeps(int row) const {
    const int g = (int)((unsigned)row_off + (unsigned)row);
    return !on || (g >= lo && g < hi);
  }
};

template <bool SW>
struct Tile {
  static constexpr int BM = SW ? 32 : 128;   // output rows per block
  static constexpr int BN = SW ? 128 : 32;   // output columns per block
  static constexpr int THREADS = BM / 16 * (BN / 16) * 32;   // a warp per 16 x 16 tile
};

template <int ND, bool SW>
__global__ void __launch_bounds__(Tile<SW>::THREADS, 1)
fused_scaled_noise_matmul_kernel(const int8_t* __restrict__ lhs,
                                 const int8_t* __restrict__ rhs,
                                 const int64_t* __restrict__ tables,
                                 const int32_t* __restrict__ ntab,
                                 const int8_t* __restrict__ noise,
                                 const int64_t* __restrict__ sc,
                                 const int64_t* __restrict__ etab,
                                 const int64_t* __restrict__ post,
                                 int64_t* __restrict__ out,
                                 int m, int n, int kd, int nrows, int jr,
                                 int vals, int encode32, Mask mask) {
  constexpr int BM = Tile<SW>::BM, BN = Tile<SW>::BN, THREADS = Tile<SW>::THREADS;
  using Banded = BandedSmem<ND, BM, BN>;
  using Swapped = SwappedSmem<ND, BM, BN>;
  __shared__ __align__(16) uint32_t sA[SW ? Swapped::A_WORDS : Banded::A_WORDS];
  __shared__ __align__(16) uint32_t sB[SW ? Swapped::B_WORDS : Banded::B_WORDS];
  __shared__ int32_t sN[MAX_ROWS * ND];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ch = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                 // mma fragment coordinates
  const int wm = warp % (BM / 16) * 16, wn = warp / (BM / 16) * 16;  // the warp's tile

  for (int i = tid; i < nrows * ND; i += THREADS)
    sN[i] = ntab[(size_t)ch * nrows * ND + i];  // read after the contraction's barriers

  int32_t acc[ND][2][4];
  zero_acc<ND>(acc);
  const auto sync = [] { __syncthreads(); };
  const bool vecA = kd % 16 == 0 && (reinterpret_cast<uintptr_t>(lhs) & 15) == 0;
  if constexpr (SW) {
    const bool vecB = kd % 16 == 0 && (reinterpret_cast<uintptr_t>(rhs) & 15) == 0;
    contract_swapped<ND, BM, BN, THREADS>(lhs + (size_t)ch * ND * m * kd,
                                          rhs + (size_t)ch * n * kd, m, n, kd, m0, n0,
                                          tid, vecA, vecB, sA, sB, acc, sync);
  } else {
    const bool vecB = n % 16 == 0 && (reinterpret_cast<uintptr_t>(rhs) & 15) == 0;
    contract_banded<ND, BM, BN, THREADS>(lhs + (size_t)ch * m * kd,
                                         rhs + (size_t)ch * ND * kd * n, m, n, kd, m0,
                                         n0, tid, vecA, vecB, sA, sB, acc, sync);
  }

  const Fold fold(tables + (size_t)ch * TAB);
  const Encode encode(etab == nullptr ? nullptr : etab + (size_t)ch * 3);
  const size_t plane = (size_t)m * n;
  // accumulator e of fragment j: row g (+8 for e >= 2), column 2t (+1 for odd e)
  auto row_of = [&](int e) { return m0 + wm + g + 8 * (e >> 1); };
  auto col_of = [&](int j, int e) { return n0 + wn + 8 * j + 2 * t + (e & 1); };
  // noise NTT into the columns: value rows (coefficient r composed from its
  // jr digit planes, against the jr = 1 table) or raw digit rows; the loads
  // of the thread's eight outputs for one row are in flight together
  for (int r = 0; r < nrows; ++r) {
    int32_t v[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_of(e), col = col_of(j, e);
        v[j][e] = 0;
        if (row >= m || col >= n) continue;
        const size_t idx = (size_t)row * n + col;
        if (vals) {
          v[j][e] = noise[(size_t)(r * jr) * plane + idx];
          if (jr == 2) v[j][e] += 256 * (int32_t)noise[(size_t)(r * 2 + 1) * plane + idx];
        } else {
          v[j][e] = noise[(size_t)r * plane + idx];
        }
      }
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int32_t w = sN[r * ND + c];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][j][e] += v[j][e] * w;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_of(e), col = col_of(j, e);
      if (row >= m || col >= n) continue;
      const size_t idx = (size_t)row * n + col;
      int32_t p[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) p[c] = acc[c][j][e];
      uint64_t res = fold(p);
      if (post != nullptr) res = addmod(res, (uint64_t)post[(size_t)ch * plane + idx], fold.q);
      if (sc != nullptr && mask.keeps(row))
        res = addmod(res, encode((uint64_t)sc[idx], encode32, fold.q), fold.q);
      out[(size_t)ch * plane + idx] = (int64_t)res;
    }
}

template <bool SW>
int launch(int ch, int m, int n, int kd, int nd, int nrows, int jr, int vals,
           int encode32, const void* lhs, const void* rhs, const void* tables,
           const void* ntab, const void* noise, const void* sc, const void* etab,
           const void* post, Mask mask, void* out, void* stream) {
  constexpr int BM = Tile<SW>::BM, BN = Tile<SW>::BN, THREADS = Tile<SW>::THREADS;
  if (ch <= 0 || ch > 65535 || m <= 0 || n <= 0 || kd <= 0 || nd < 1 || nd > 8 ||
      nrows < 0 || nrows > MAX_ROWS || (nrows > 0 && jr != 1 && jr != 2) ||
      (nrows > 0 && noise == nullptr) || (sc == nullptr) != (etab == nullptr) ||
      (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, ch);
  cudaStream_t s = (cudaStream_t)stream;
  const auto go = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(
        (const int8_t*)lhs, (const int8_t*)rhs, (const int64_t*)tables,
        (const int32_t*)ntab, (const int8_t*)noise, (const int64_t*)sc,
        (const int64_t*)etab, (const int64_t*)post, (int64_t*)out, m, n, kd, nrows, jr,
        vals, encode32, mask);
  };
  switch (nd) {
    case 1: go(fused_scaled_noise_matmul_kernel<1, SW>); break;
    case 2: go(fused_scaled_noise_matmul_kernel<2, SW>); break;
    case 3: go(fused_scaled_noise_matmul_kernel<3, SW>); break;
    case 4: go(fused_scaled_noise_matmul_kernel<4, SW>); break;
    case 5: go(fused_scaled_noise_matmul_kernel<5, SW>); break;
    case 6: go(fused_scaled_noise_matmul_kernel<6, SW>); break;
    case 7: go(fused_scaled_noise_matmul_kernel<7, SW>); break;
    default: go(fused_scaled_noise_matmul_kernel<8, SW>); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both launch on ``stream`` and return cudaGetLastError() (0 on success).
// ``noise`` may be null (nrows = 0); ``sc`` and ``etab`` are null without the
// encode; ``post`` (int64 [ch, m, n], canonical residues) is null without
// it. ``masked`` 1 adds the encode only on the global rows row_off + r in
// [lo, hi). All arrays are contiguous.

// lhs int8 [ch, m, kd], band int8 [ch, nd, kd, n].
extern "C" int pvw_fused_scaled_noise_matmul(
    const void* lhs, const void* band, const void* tables, const void* ntab,
    const void* noise, const void* sc, const void* etab, const void* post, void* out,
    int ch, int m, int n, int kd, int nd, int nrows, int jr, int vals, int encode32,
    int masked, int row_off, int lo, int hi, void* stream) {
  return launch<false>(ch, m, n, kd, nd, nrows, jr, vals, encode32, lhs, band, tables,
                       ntab, noise, sc, etab, post, Mask{masked, row_off, lo, hi}, out,
                       stream);
}

// The swapped form: lhs int8 [ch, nd, m, kd] scaled planes, rhs int8
// [ch, n, kd] plain digits, k-packed.
extern "C" int pvw_fused_scaled_noise_matmul_swapped(
    const void* lhs, const void* rhs, const void* tables, const void* ntab,
    const void* noise, const void* sc, const void* etab, const void* post, void* out,
    int ch, int m, int n, int kd, int nd, int nrows, int jr, int vals, int encode32,
    int masked, int row_off, int lo, int hi, void* stream) {
  return launch<true>(ch, m, n, kd, nd, nrows, jr, vals, encode32, lhs, rhs, tables,
                      ntab, noise, sc, etab, post, Mask{masked, row_off, lo, hi}, out,
                      stream);
}
