// Kernel 1's int8 digit contraction with a trivial epilogue, in three band
// layouts, for Hopper (sm_90a): what the contraction costs without the fold.
//
// Replaces the three TPU kernels of benchmarks/probe_dot_structure.py:
// pallas_dots (body :80, nd separate dots), pallas_one_dot (:109, one dot
// on a band merged along its lanes, :107) and pallas_wide_dot (:148, one dot
// on a band interleaved in blocks of TN columns, :141-145). Each computes,
// per channel ch, for lhs int8 [CH, m, kd] and the nd band planes b_c
// int8 [kd, D],
//
//   out[ch, r, j] = p_0 + sum_{c>=1} (p_c >> (c + 1))     int32, wrapping,
//   p_c = sum_k lhs[ch, r, k] * b_c[k, j]                  (arithmetic shifts)
//
// What bounds it on an H100: the int8 products, 2*CH*m*kd*nd*D operations
// at 1,979 TOPS (1.74 ms at the toy c2 shape CH = 16, m = D = 4096,
// kd = 1280, nd = 5; 9.45 ms at config 4's CH = 272, m = D = 1024,
// kd = 4096, nd = 8). So every variant contracts on wgmma s8 fed by the TMA
// ring of wgmma_digit.cuh (a producer and two ping-pong consumer
// warpgroups, a persistent grid of 64 x 32 output tiles, the channel
// slowest, the ring as deep as kernel 1's), as kernel 1 does; only the
// epilogue differs from kernel 1's.
//
// wgmma reads 8-bit B K-major only, and all three TPU layouts put the
// output columns innermost. So each band is stored with k innermost (rows
// on 16 bytes), the TPU layout's other axes kept in order:
//   planes   [CH, nd, D, kd]          (kernel 1's k-packed band): a k step
//            is nd products m64n32k32, one a plane, into nd accumulator
//            sets; a thread holds every plane of its outputs;
//   one_dot  [CH, D, nd, kd]: one m64n(32nd)k32 product whose columns are
//            digit-minor (column j*nd + c), so an output's nd columns lie in
//            several threads: they are summed in shared memory (one 32-bit
//            atomic add a term, a thread's two neighbouring columns added
//            first where they share an output), then stored coalesced;
//   wide     [CH, D/TN, nd, TN, kd] (TN a multiple of 32): one
//            m64n(32nd)k32 product over nd blocks of 32 columns, kernel 1's
//            arrangement; a thread holds every plane of its outputs.
// TMA zero-fills past kd, m and D, so no tail code touches the contraction.

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_digit.cuh"

namespace {

using namespace wgmma_digit;

enum Layout { PLANES = 0, ONE_DOT = 1, WIDE = 2 };

// Beside the ring, each consumer keeps kernel 1's epilogue scratch, so the
// ring has kernel 1's depth (3 stages at nd = 8, 5 at nd = 5) and the two
// differ in their epilogues alone; one_dot sums its output tile in the
// first SUM_BYTES of it.
constexpr int SCRATCH = scratch_bytes(false);
constexpr int SUM_BYTES = BM * BN * 4;
static_assert(SUM_BYTES <= SCRATCH, "the one_dot tile must fit a consumer's scratch");

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// Producer: the stages of this block's tiles in order, as wgmma_digit's
// ``produce``, with the B box placed by the layout (its rows in shared
// memory: plane c's 32 columns at rows 32c.., or column j's nd digits at
// rows nd*j.. for one_dot).
template <int ND, int LAYOUT, class Tiles>
__device__ __forceinline__ void produce_band(const Ring<ND>& R, const CUtensorMap* ma,
                                             const CUtensorMap* mb, const Tiles& tiles,
                                             int count, int nk, int tn) {
  for (int j = 0; j < count; ++j) {
    int ch, a0, b0;
    tiles(j, ch, a0, b0);
    for (int kb = 0; kb < nk; ++kb) {
      const int it = j * nk + kb, s = it % R.S;
      mbar_wait(&R.empty[s], ((it / R.S) & 1) ^ 1);
      mbar_expect_tx(&R.full[s], Ring<ND>::STAGE);
      tma_load_3d(R.a(s), ma, &R.full[s], kb * KT, a0, ch);
      if (LAYOUT == PLANES)
        tma_load_4d(R.b(s), mb, &R.full[s], kb * KT, b0, 0, ch);
      else if (LAYOUT == ONE_DOT)
        tma_load_4d(R.b(s), mb, &R.full[s], kb * KT, 0, b0, ch);
      else
        tma_load_5d(R.b(s), mb, &R.full[s], kb * KT, b0 % tn, 0, b0 / tn, ch);
    }
  }
}

// nd products m64n32k32 of one 32-byte k step, plane c into accumulator
// registers 16c .. 16c + 15 (disjoint sets: products in flight into them
// need no order)
template <int ND, int C = 0>
__device__ __forceinline__ void plane_mmas(int32_t (&acc)[16 * ND], uint64_t da, uint64_t db,
                                           int accumulate) {
  if constexpr (C < ND) {
    Wgmma<32>::template mma<16 * C>(acc, da, db + (uint64_t)((C * PLANE_BYTES) >> 4),
                                    accumulate);
    plane_mmas<ND, C + 1>(acc, da, db, accumulate);
  }
}

// wgmma_digit's ``contract`` (the same turns and stage releases) with the
// planes variant's nd products a k step
template <int ND>
__device__ __forceinline__ void contract_planes(int32_t (&acc)[16 * ND], const Ring<ND>& R,
                                                int j, int nk, int wg, bool wait_turn,
                                                bool pass_turn, bool lane0) {
  if (wait_turn) asm volatile("bar.sync %0, 256;" ::"r"(BAR_TURN + wg) : "memory");
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb) {
    const int it = j * nk + kb, s = it % R.S;
    mbar_wait(&R.full[s], (it / R.S) & 1);
    const uint64_t da = sw128_desc(R.a(s)), db = sw128_desc(R.b(s));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 32; ++kk) plane_mmas<ND>(acc, da + 2 * kk, db + 2 * kk, kb | kk);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && lane0) mbar_arrive(&R.empty[prev]);
    prev = s;
  }
  if (pass_turn) asm volatile("bar.arrive %0, 256;" ::"r"(BAR_TURN + 1 - wg) : "memory");
  wgmma_wait<0>();
  if (lane0) mbar_arrive(&R.empty[prev]);
  fence_regs(acc);
}

// The epilogue where a thread holds every plane of its outputs (planes,
// wide): output x = 8h + 2i + e at tile row 16w + g + 8h, column
// 8i + 2t + e, plane c in acc[16c + 4i + 2h + e]; neighbouring columns
// stored as one 8-byte pair where aligned.
template <int ND>
__device__ __forceinline__ void store_own(const int32_t (&acc)[16 * ND], int32_t* out, int ch,
                                          int m, int n, int a0, int b0, int tl) {
  const int w = tl / 32, lane = tl % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int x = 0; x < 16; x += 2) {
    const int i = x >> 1 & 3, h = x >> 3;
    const int row = a0 + 16 * w + g + 8 * h, col = b0 + 8 * i + 2 * t;
    uint32_t s[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 4 * i + 2 * h + e;
      s[e] = (uint32_t)acc[r];
#pragma unroll
      for (int c = 1; c < ND; ++c) s[e] += (uint32_t)(acc[16 * c + r] >> (c + 1));
    }
    if (row >= m) continue;
    const size_t o = ((size_t)ch * m + row) * n + col;
    if (col + 1 < n && o % 2 == 0) {
      *reinterpret_cast<int2*>(out + o) = make_int2((int32_t)s[0], (int32_t)s[1]);
    } else {
      if (col < n) out[o] = (int32_t)s[0];
      if (col + 1 < n) out[o + 1] = (int32_t)s[1];
    }
  }
}

// The one_dot epilogue: accumulator column 8i + 2t + e is digit
// (8i + 2t + e) % nd of output column (8i + 2t + e) / nd; each term goes to
// the consumer's output tile ``sums`` [64][32] (zero on entry) by a shared
// atomic add, then the tile is stored coalesced and zeroed again.
template <int ND>
__device__ __forceinline__ void store_shared(const int32_t (&acc)[16 * ND], uint32_t* sums,
                                             int32_t* out, int ch, int m, int n, int a0,
                                             int b0, int tl, int bar) {
  const int w = tl / 32, lane = tl % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) {
    const int c0 = 8 * i + 2 * t;                      // the column of e = 0
    const int j0 = c0 / ND, j1 = (c0 + 1) / ND;
    const int d0 = c0 % ND, d1 = (c0 + 1) % ND;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int32_t p0 = acc[4 * i + 2 * h], p1 = acc[4 * i + 2 * h + 1];
      const uint32_t v0 = (uint32_t)(d0 == 0 ? p0 : p0 >> (d0 + 1));
      const uint32_t v1 = (uint32_t)(d1 == 0 ? p1 : p1 >> (d1 + 1));
      uint32_t* rowp = sums + (16 * w + g + 8 * h) * BN;
      if (j0 == j1) {
        atomicAdd(rowp + j0, v0 + v1);
      } else {
        atomicAdd(rowp + j0, v0);
        atomicAdd(rowp + j1, v1);
      }
    }
  }
  wg_sync(bar);
#pragma unroll 4
  for (int q = 0; q < BM * BN / 128; ++q) {
    const int e = tl + 128 * q, r = e / BN, c = e % BN;
    const uint32_t v = sums[e];
    sums[e] = 0;
    if (a0 + r < m && b0 + c < n) out[((size_t)ch * m + a0 + r) * n + b0 + c] = (int32_t)v;
  }
  wg_sync(bar);
}

template <int ND, int LAYOUT>
__global__ void __launch_bounds__(THREADS, 1)
dot_structure_kernel(const __grid_constant__ CUtensorMap ma,
                     const __grid_constant__ CUtensorMap mb, int32_t* __restrict__ out,
                     int chs, int m, int n, int nk, int stages, int tn) {
  extern __shared__ uint8_t smem[];
  const Ring<ND> R(smem, stages, 2 * SCRATCH);
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  const int tiles_a = (m + BM - 1) / BM, tiles_b = (n + BN - 1) / BN;
  const int total = chs * tiles_a * tiles_b;
  const int count = (int)blockIdx.x < total
                        ? (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  // tile j of this block: the channel slowest, the A tile fastest (kernel 1's walk)
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
    if (threadIdx.x == 0) produce_band<ND, LAYOUT>(R, &ma, &mb, tile, count, nk, tn);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tl = threadIdx.x % 128, bar = BAR_EPI + wg - 1;
    uint32_t* sums = reinterpret_cast<uint32_t*>(R.extra() + (wg - 1) * SCRATCH);
    if (LAYOUT == ONE_DOT) {
      for (int e = tl; e < BM * BN; e += 128) sums[e] = 0;
      wg_sync(bar);
    }
    int32_t acc[16 * ND];
    for (int j = wg - 1; j < count; j += 2) {
      int ch, a0, b0;
      tile(j, ch, a0, b0);
      if (LAYOUT == PLANES)
        contract_planes(acc, R, j, nk, wg - 1, j > 0, j + 1 < count, tl % 32 == 0);
      else
        contract(acc, R, j, nk, wg - 1, j > 0, j + 1 < count, tl % 32 == 0);
      if (LAYOUT == ONE_DOT)
        store_shared<ND>(acc, sums, out, ch, m, n, a0, b0, tl, bar);
      else
        store_own<ND>(acc, out, ch, m, n, a0, b0, tl);
    }
  }
}

// A K-major int8 tensor map: dims[0] = kd (box KT), then ``rank - 1`` outer
// dims with their byte strides and boxes; 128-byte swizzle, zero fill.
int make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
             const long long* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(ptr) & 15) != 0) return (int)cudaErrorInvalidValue;
  cuuint64_t str[4];
  for (int d = 0; d < rank - 1; ++d) {
    if (strides[d] <= 0 || strides[d] % 16 != 0) return (int)cudaErrorInvalidValue;
    str[d] = (cuuint64_t)strides[d];
  }
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims, str, box,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int LAYOUT>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, int32_t* out, int ch, int m, int n,
           int kd, int nd, int tn, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)ch * ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (total > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int grid = (int)(total < sms ? total : sms);
  const int nk = (kd + KT - 1) / KT;
  constexpr int EXTRA = 2 * SCRATCH;
  const auto go = [&](auto kernel, int stages, int bytes) -> int {
    if (stages < 2) return (int)cudaErrorInvalidValue;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, THREADS, bytes, s>>>(ma, mb, out, ch, m, n, nk, stages, tn);
    return (int)cudaGetLastError();
  };
#define PVW_GO(ND)                                                                        \
  case ND:                                                                                \
    return go(dot_structure_kernel<ND, LAYOUT>, ring_stages<ND>(EXTRA),                   \
              smem_bytes<ND>(ring_stages<ND>(EXTRA), EXTRA));
  switch (nd) {
    PVW_GO(1) PVW_GO(2) PVW_GO(3) PVW_GO(4) PVW_GO(5) PVW_GO(6) PVW_GO(7)
    default: PVW_GO(8)
  }
#undef PVW_GO
}

}  // namespace

// lhs int8 [ch, m, kd], k contiguous (byte strides lhs_row, lhs_ch); the
// band int8, k contiguous, stored per ``layout`` (0 planes [ch, nd, n, kd],
// 1 one_dot [ch, n, nd, kd], 2 wide [ch, n/tn, nd, tn, kd]) with the byte
// strides of its outer axes innermost first (s1, s2, s3 and, for wide, s4);
// out int32 [ch, m, n], contiguous. Every stride and both bases on 16
// bytes; nd <= 8; wide: tn a multiple of 32 dividing n. Launches on
// ``stream``; returns a CUDA error code (0 on success).
extern "C" int pvw_dot_structure(const void* lhs, long long lhs_row, long long lhs_ch,
                                 const void* band, long long s1, long long s2, long long s3,
                                 long long s4, void* out, int layout, int ch, int m, int n,
                                 int kd, int nd, int tn, void* stream) {
  if (ch <= 0 || m <= 0 || n <= 0 || kd <= 0 || nd < 1 || nd > 8 || layout < 0 ||
      layout > 2 || (layout == WIDE && (tn <= 0 || tn % BN != 0 || n % tn != 0)) ||
      (long long)m * n > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const cuuint64_t adim[3] = {(cuuint64_t)kd, (cuuint64_t)m, (cuuint64_t)ch};
  const long long astr[2] = {lhs_row, lhs_ch};
  const cuuint32_t abox[3] = {KT, BM, 1};
  if (const int err = make_map(&ma, lhs, 3, adim, astr, abox)) return err;
  const long long bstr[4] = {s1, s2, s3, s4};
  const cuuint32_t ndb = (cuuint32_t)nd;
  int err = 0;
  if (layout == PLANES) {
    const cuuint64_t d[4] = {(cuuint64_t)kd, (cuuint64_t)n, (cuuint64_t)nd, (cuuint64_t)ch};
    const cuuint32_t b[4] = {KT, BN, ndb, 1};
    err = make_map(&mb, band, 4, d, bstr, b);
  } else if (layout == ONE_DOT) {
    const cuuint64_t d[4] = {(cuuint64_t)kd, (cuuint64_t)nd, (cuuint64_t)n, (cuuint64_t)ch};
    const cuuint32_t b[4] = {KT, ndb, BN, 1};
    err = make_map(&mb, band, 4, d, bstr, b);
  } else {
    const cuuint64_t d[5] = {(cuuint64_t)kd, (cuuint64_t)tn, (cuuint64_t)nd,
                             (cuuint64_t)(n / tn), (cuuint64_t)ch};
    const cuuint32_t b[5] = {KT, BN, ndb, 1, 1};
    err = make_map(&mb, band, 5, d, bstr, b);
  }
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  if (layout == PLANES) return launch<PLANES>(ma, mb, o, ch, m, n, kd, nd, tn, s);
  if (layout == ONE_DOT) return launch<ONE_DOT>(ma, mb, o, ch, m, n, kd, nd, tn, s);
  return launch<WIDE>(ma, mb, o, ch, m, n, kd, nd, tn, s);
}
