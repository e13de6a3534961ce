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
// with the nd int32 columns P_c of the digit contraction (wgmma_digit.cuh):
// - banded: A = lhs int8 [CH, m, kd] and B = the band int8 [CH, nd, n, kd],
//   k-packed as kernel 4 writes it (kd = k*nd; the band carries the 2^(8i)
//   scales), P_c = lhs . band[c];
// - swapped: the scales live on the cached lhs, lhs int8 [CH, nd, m, kd] of
//   digit_c(A*2^(8i) mod q) planes, and the rhs is the plain digits of r,
//   k-packed, int8 [CH, n, kd]; A = the rhs (64 dealers a tile), B = the
//   lhs planes (32 receivers a tile), P_c = lhs[c] . rhs, and the epilogue
//   writes the transposed tile. Same columns, same fold, the same residues.
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
// 3.35 TB/s (the swapped lhs is 9.1 GB there, 5.2 ms). So the contraction
// runs on wgmma.mma_async s8 x s8 -> s32, the only path to the int8 peak,
// fed by TMA (cp.async.bulk.tensor into an mbarrier ring), with no mma.sync
// and no staging through registers.
//
// The design: a persistent grid of one block an SM walks the tiles (64 rows
// of A x 32 columns of every B plane) with the channel slowest and the A
// tile fastest, so the blocks in flight share a few B tiles (the operand of
// nd planes, 1 MB a tile at config-4 c2) in L2 rather than the channel's
// whole B (32 MB there): 19% faster at config-4 c2 than the B tile fastest
// (the ``walk_b`` variant of probes/fused_matmul_variants.py).
// Its producer warpgroup keeps an S-stage TMA ring full (S = 3 at nd = 8,
// 5 at nd = 5, beside each consumer's 34 KB of epilogue scratch); its two
// consumer warpgroups take alternate tiles, each contracting with one wgmma
// m64n(32*nd)k32 a 32-byte k step (n256 at nd = 8: 128 accumulator
// registers a thread), then running the epilogue from its registers (noise
// MAC, native 64-bit Shoup fold, post, masked encode, int64 stores) while
// the other contracts the next tile. The epilogue's inputs (the noise
// table, the scalars, the first noise planes) are copied to the consumer's
// shared memory with cp.async before its contraction, so they arrive while
// it runs: at config 4 the tile's loads otherwise wait on an L2 busy with
// the TMA stream. The swapped form's transposed stores need no staging: a
// warp's eight A rows are eight consecutive int64 of one output row, whole
// 32-byte sectors.

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_digit.cuh"

namespace {

using namespace wgmma_digit;

constexpr int SCRATCH = scratch_bytes(false);   // a consumer's, beside the ring

template <int ND, bool SW>
__global__ void __launch_bounds__(THREADS, 1)
fused_scaled_noise_matmul_kernel(const __grid_constant__ CUtensorMap ma,
                                 const __grid_constant__ CUtensorMap mb, Epilogue E,
                                 const int8_t* __restrict__ noise, int chs, int rows,
                                 int cols, int nk, int stages) {
  extern __shared__ uint8_t smem[];
  const Ring<ND> R(smem, stages, 2 * SCRATCH);
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  const int tiles_a = (rows + BM - 1) / BM, tiles_b = (cols + BN - 1) / BN;
  const int total = chs * tiles_a * tiles_b;
  const int count = (int)blockIdx.x < total
                        ? (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  // tile j of this block: the channel slowest, the A tile fastest
  const auto tile = [&](int j, int& ch, int& a0, int& b0) {
    const int gi = (int)blockIdx.x + j * (int)gridDim.x;
    ch = gi / (tiles_a * tiles_b);
    const int rem = gi % (tiles_a * tiles_b);
    a0 = rem % tiles_a * BM;
    b0 = rem / tiles_a * BN;
  };
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) produce(R, &ma, &mb, tile, count, nk);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tl = threadIdx.x % 128;
    uint8_t* scratch = R.extra() + (wg - 1) * SCRATCH;
    int32_t acc[16 * ND];
    for (int j = wg - 1; j < count; j += 2) {
      int ch, a0, b0;
      tile(j, ch, a0, b0);
      prefetch<ND, SW, false>(E, noise, ch, a0, b0, tl, scratch);
      contract(acc, R, j, nk, wg - 1, j > 0, j + 1 < count, tl % 32 == 0);
      epilogue<ND, SW, false>(acc, E, noise, ch, a0, b0, tl, scratch, BAR_EPI + wg - 1);
    }
  }
}

template <bool SW>
int launch(const Operand& a, const Operand& b, int ch, int m, int n, int kd, int nd,
           int nrows, int jr, int vals, int encode32, const void* tables, const void* ntab,
           const void* noise, const void* sc, const void* etab, const void* post, Mask mask,
           void* out, void* stream) {
  if (ch <= 0 || m <= 0 || n <= 0 || kd <= 0 || nd < 1 || nd > 8 || nrows < 0 ||
      nrows > MAX_ROWS || (nrows > 0 && jr != 1 && jr != 2) ||
      (nrows > 0 && noise == nullptr) || (sc == nullptr) != (etab == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rows = SW ? n : m, cols = SW ? m : n;      // of A and of each B plane
  CUtensorMap ma, mb;
  if (const int err = make_maps(&ma, &mb, a, b, ch, rows, cols, kd, nd)) return err;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long total =
      (long long)ch * ((rows + BM - 1) / BM) * ((cols + BN - 1) / BN);
  if (total > 0x7FFFFFFF || (long long)m * n > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int grid = (int)(total < sms ? total : sms);
  const Epilogue E{(const int64_t*)tables, (const int32_t*)ntab, (const int64_t*)sc,
                   (const int64_t*)etab, (const int64_t*)post, (int64_t*)out,
                   m, n, nrows, jr, vals, encode32, mask};
  cudaStream_t s = (cudaStream_t)stream;
  const int nk = (kd + KT - 1) / KT;
  const auto go = [&](auto kernel, int stages, int bytes) -> int {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, THREADS, bytes, s>>>(ma, mb, E, (const int8_t*)noise, ch, rows, cols, nk,
                                        stages);
    return (int)cudaGetLastError();
  };
#define PVW_GO(ND)                                                               \
  case ND:                                                                       \
    return go(fused_scaled_noise_matmul_kernel<ND, SW>,                         \
              ring_stages<ND>(2 * SCRATCH),                                      \
              smem_bytes<ND>(ring_stages<ND>(2 * SCRATCH), 2 * SCRATCH));
  switch (nd) {
    PVW_GO(1) PVW_GO(2) PVW_GO(3) PVW_GO(4) PVW_GO(5) PVW_GO(6) PVW_GO(7)
    default: PVW_GO(8)
  }
#undef PVW_GO
}

}  // namespace

// Both launch on ``stream`` and return a CUDA error code (0 on success;
// a failed tensor-map encode is cudaErrorInvalidValue). ``noise`` may be
// null (nrows = 0); ``sc`` and ``etab`` are null without the encode;
// ``post`` (int64 [ch, m, n], canonical residues) is null without it.
// ``masked`` 1 adds the encode only on the global rows row_off + r in
// [lo, hi). The int8 operands are k-contiguous with the byte strides
// given, each a multiple of 16, and a 16-byte aligned base; tables, ntab,
// noise, sc, etab, post and out are contiguous.

// lhs int8 [ch, m, kd] (strides lhs_row, lhs_ch), band int8 [ch, nd, n, kd]
// k-packed (band_row, band_plane, band_ch).
extern "C" int pvw_fused_scaled_noise_matmul(
    const void* lhs, long long lhs_row, long long lhs_ch, const void* band,
    long long band_row, long long band_plane, long long band_ch, const void* tables,
    const void* ntab, const void* noise, const void* sc, const void* etab, const void* post,
    void* out, int ch, int m, int n, int kd, int nd, int nrows, int jr, int vals,
    int encode32, int masked, int row_off, int lo, int hi, void* stream) {
  return launch<false>(Operand{lhs, lhs_row, 0, lhs_ch},
                       Operand{band, band_row, band_plane, band_ch}, ch, m, n, kd, nd, nrows,
                       jr, vals, encode32, tables, ntab, noise, sc, etab, post,
                       Mask{masked, row_off, lo, hi}, out, stream);
}

// The swapped form: rhs int8 [ch, n, kd] plain digits, k-packed (rhs_row,
// rhs_ch), lhs int8 [ch, nd, m, kd] scaled planes (lhs_row, lhs_plane,
// lhs_ch); no post and no mask.
extern "C" int pvw_fused_scaled_noise_matmul_swapped(
    const void* rhs, long long rhs_row, long long rhs_ch, const void* lhs,
    long long lhs_row, long long lhs_plane, long long lhs_ch, const void* tables,
    const void* ntab, const void* noise, const void* sc, const void* etab, const void* post,
    void* out, int ch, int m, int n, int kd, int nd, int nrows, int jr, int vals,
    int encode32, int masked, int row_off, int lo, int hi, void* stream) {
  if (post != nullptr || masked) return (int)cudaErrorInvalidValue;
  return launch<true>(Operand{rhs, rhs_row, 0, rhs_ch},
                      Operand{lhs, lhs_row, lhs_plane, lhs_ch}, ch, m, n, kd, nd, nrows, jr,
                      vals, encode32, tables, ntab, noise, sc, etab, post,
                      Mask{0, row_off, lo, hi}, out, stream);
}
