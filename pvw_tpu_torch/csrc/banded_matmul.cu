// Kernel 2: the modular matmul of two residue matrices per channel, by the
// digit convolution, on Hopper's warpgroup tensor cores (sm_90a).
//
// Replaces the TPU kernel pvw_tpu/ops/pallas_modmat.py::_fused_banded_matmul
// as matmul_channels_pallas and matmul_fold_auto reach it. Per channel ch
// (limb i, NTT slot s) it computes, canonical in [0, q_i):
//
//   out[ch, m, n] = sum_k lhs[ch, m, k] * rhs[ch, k, n]  mod q
//                 = ( sum_{c < 2nd-1} 2^(8c) * P_c[m, n] ) mod q,
//   P_c = sum_{i + j = c} sum_k a_i[m, k] * b_j[k, n],
//
// a_i and b_j the nd balanced signed digits of the residues. The TPU kernel
// contracts the lhs digits against a materialised convolution band
// [C, k*nd, n] (C = 2nd - 1 columns, C*nd digit products for each (m, n, k),
// most of them against zeros). Here the entry lays both operands' digits
// out digit-major and k-contiguous (fused_modmat.digit_planes_kpacked), lhs
// int8 [CH, nd, m, k] and rhs int8 [CH, nd, n, k], each row on a 16-byte
// pitch with zero pads; no band reaches device memory. Every output is the
// canonical residue, so any exact scheme gives the TPU kernel's bytes.
//
// What bounds it on an H100: the digit products, nd^2 * m * n * k useful
// int8 MACs a channel. At [16 ch, 4096 x 256] x [256 x 1024], nd = 5, that
// is 4.3e11, 0.43 ms at the int8 tensor-core peak (1,979 TOPS); at config
// 4's [272 ch, 1024 x 512] x [512 x 1024], nd = 8, 9.35e12, 9.45 ms. The
// residues in and out (8 bytes each) take 0.21 / 1.36 ms at 3.35 TB/s. So
// the bound is compute, and the contraction runs on wgmma.mma_async s8 x s8
// -> s32 fed by TMA (csrc/wgmma_digit.cuh's primitives: cp.async.bulk.tensor
// into an mbarrier ring, the producer and barrier protocol of its produce /
// contract).
//
// The design: a persistent grid of one block an SM walks the 64 x 32 output
// tiles (the channel slowest, the A tile fastest). A stage of the ring is
// 64 k bytes (the 64-byte swizzle) of the tile's nd lhs planes (A, 64 rows
// each) and of its nd rhs planes, cut in two halves of 16 columns: three
// TMA boxes. A producer warp keeps the ring full, tile after tile; the two
// consumer warpgroups share every stage (cooperative: each A stage is read
// by both, so the L2 re-reads of A halve against 64 x 16 tiles) and each
// owns one half. Column c of the digit convolution lies in accumulator
// registers 8c..8c+7 of every thread, the same (row, column) for every c:
// the fold runs in registers with no shuffle.
//
// Each half's nd planes sit in shared memory between runs of nd - 1 zero
// blocks, so that the C-block window starting i blocks before its plane 0
// holds rhs plane c - i at block c: for each 32-byte k step and lhs digit i,
// one wgmma m64n(16C)k32 with A = plane i and B = that window adds the
// digit's products into all C columns. So the tensor cores run nd * C
// products for the nd^2 useful ones (15/8 at nd = 8, 9/5 at nd = 5), on
// purpose: products into overlapping runs of registers are not ordered
// while in flight (only those of one shape into the same registers are),
// so the narrower m64n(16nd)k32 into columns i..i+nd-1 gave wrong sums,
// and the exact alternative, one m64n16k32 a digit pair (nd^2 of them,
// each into its own column), re-reads A from shared memory nd times and
// measured a quarter slower at config 4 (probes/fused_matmul_variants.py,
// k2_pairs; PERF.md). A stage holds 64 k bytes: with 128, nd = 8 would
// leave room for one stage, and the ring needs two.
//
// Two consumer warpgroups and a producer warp (288 threads): the C*8
// accumulators (120 at nd = 8) and the fold fit in 168 registers, so no
// setmaxnreg split is needed (a producer warpgroup, the k2_384 variant,
// measures the same; the narrower products above spilled up to 2.6 KB,
// k2_slices). The accumulators are zeroed at a tile's start and every product
// adds to them. The epilogue folds the C int32 columns with up to four
// 64-bit Shoup multiplies (the grouped fold, four groups) and stores int64
// pairs, while the producer already loads the next tile's stages. TMA
// zero-fills past k, m and n, so no tail code touches the contraction.

#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "wgmma_digit.cuh"

namespace {

using namespace wgmma_digit;

constexpr int BM2 = 64;                 // rows of A a tile: one wgmma m64
constexpr int HALF = 16;                // columns of each rhs plane a consumer
constexpr int BN2 = 2 * HALF;           // columns a tile
constexpr int KB = 64;                  // k bytes a stage: one 64-byte swizzled row
constexpr int TAB = 10;                 // per-channel fold table width
constexpr int SLACK = 1024 + 2 * MAX_STAGES * 8;   // ring alignment, barriers
constexpr int THREADS2 = 2 * 128 + 32;   // two consumer warpgroups, a producer warp

// the shared-memory descriptor of a K-major tile of KB-byte rows with the
// KB-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_64B or _128B): start
// address, the stride of 8 rows, layout type 2 (64-byte) or 1 (128-byte);
// +2 advances it by 32 k bytes
__device__ __forceinline__ uint64_t swizzled_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * KB >> 4) << 32) | ((uint64_t)(KB == 128 ? 1 : 2) << 62);
}

// A stage: the nd A planes (64 rows each), then the B region of blocks of
// 16 rows: [nd-1 zero blocks, half 0's nd planes, nd-1 zero blocks, half
// 1's nd planes, nd-1 zero blocks]; half h's plane 0 is block (nd-1) +
// h*(2nd-1). The zero blocks are written once, before the ring starts.
template <int ND>
struct Stage {
  static constexpr int A_PLANE = BM2 * KB;             // 4 KB
  static constexpr int B_PLANE = HALF * KB;            // 1 KB
  static constexpr int B_HALF = ND * B_PLANE;          // a consumer's nd planes
  static constexpr int BYTES = ND * A_PLANE + (5 * ND - 3) * B_PLANE;
  __host__ __device__ static constexpr int half_at(int h) {
    return ND * A_PLANE + ((ND - 1) + h * (2 * ND - 1)) * B_PLANE;
  }
};

template <int ND>
__host__ __device__ constexpr int stages() {
  const int s = (MAX_SMEM - SLACK) / Stage<ND>::BYTES;
  return s > MAX_STAGES ? MAX_STAGES : s;
}

// Per-channel fold constants, from tables [CH, TAB] int64: q, the bias K
// (sum_{c<C} 2^31 * 2^(8c) mod q), then (w_g, w_g') for g < 4: w_g = 2^(32g)
// mod q and its 64-bit Shoup companion.
template <int C>
struct Fold {
  static constexpr int NG = (C + 3) / 4;
  uint64_t q, bias, w[NG], wp[NG];
  __device__ __forceinline__ explicit Fold(const int64_t* T)
      : q((uint64_t)T[0]), bias((uint64_t)T[1]) {
#pragma unroll
    for (int g = 0; g < NG; ++g) w[g] = (uint64_t)T[2 + 2 * g], wp[g] = (uint64_t)T[3 + 2 * g];
  }

  // exact fold of C int32 columns: bias each by 2^31, four per u64 group
  __device__ __forceinline__ uint64_t operator()(const int32_t (&p)[C]) const {
    uint64_t G[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) G[g] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c)
      G[c / 4] += (uint64_t)((uint32_t)p[c] ^ 0x80000000u) << (8 * (c % 4));
    uint64_t res = shoup(G[0], w[0], wp[0], q);
#pragma unroll
    for (int g = 1; g < NG; ++g) res = addmod(res, shoup(G[g], w[g], wp[g], q), q);
    return submod(res, bias, q);
  }
};

// One 32-byte k step of a consumer: for each lhs digit I, plane I of A
// against the C-block window of B that starts I blocks before the half's
// plane 0 (block c: rhs plane c - I, or zeros), into all C columns. Every
// product has one shape and one accumulator, so the hardware orders them.
template <int ND, int... I>
__device__ __forceinline__ void window_products(int32_t (&acc)[8 * (2 * ND - 1)], uint64_t da,
                                                uint64_t db, std::integer_sequence<int, I...>) {
  (Wgmma<HALF * (2 * ND - 1)>::template mma<0>(
       acc, da + I * (Stage<ND>::A_PLANE >> 4), db - I * (Stage<ND>::B_PLANE >> 4), 1),
   ...);
}

template <int ND>
__global__ void __launch_bounds__(THREADS2, 1)
banded_matmul_kernel(const __grid_constant__ CUtensorMap ma,
                     const __grid_constant__ CUtensorMap mb,
                     const int64_t* __restrict__ tables, int64_t* __restrict__ out, int chs,
                     int m, int n, int nk, int S) {
  constexpr int C = 2 * ND - 1;
  using St = Stage<ND>;
  extern __shared__ uint8_t smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem) + 1023) &
                                             ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + (size_t)S * St::BYTES);
  uint64_t* empty = full + S;
  static_assert(stages<ND>() >= 2, "the ring needs two stages");
  // the zero blocks of every slot, made visible to the tensor cores' reads
  for (int s = 0; s < S; ++s)
    for (int z = 0; z < 3; ++z) {
      uint4* zb = reinterpret_cast<uint4*>(base + (size_t)s * St::BYTES + ND * St::A_PLANE +
                                           (size_t)z * (2 * ND - 1) * St::B_PLANE);
      for (int e = threadIdx.x; e < (ND - 1) * St::B_PLANE / 16; e += blockDim.x)
        zb[e] = make_uint4(0, 0, 0, 0);
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);           // the eight warps of the two consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int tiles_a = (m + BM2 - 1) / BM2, tiles_b = (n + BN2 - 1) / BN2;
  const int total = chs * tiles_a * tiles_b;
  const int count = (int)blockIdx.x < total
                        ? (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  // tile j of this block: the channel slowest, the A tile fastest
  const auto tile = [&](int j, int& ch, int& a0, int& b0) {
    const int gi = (int)blockIdx.x + j * (int)gridDim.x;
    ch = gi / (tiles_a * tiles_b);
    const int rem = gi % (tiles_a * tiles_b);
    a0 = rem % tiles_a * BM2;
    b0 = rem / tiles_a * BN2;
  };
  const auto a_stage = [&](int s) { return base + (size_t)s * St::BYTES; };
  const auto b_half = [&](int s, int h) { return a_stage(s) + St::half_at(h); };

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x != 256) return;
    // the producer: tile j's nk stages into slots (j*nk + kb) % S, in order;
    // a second half wholly past n is not loaded (its consumer's products
    // are never stored)
    for (int j = 0; j < count; ++j) {
      int ch, a0, b0;
      tile(j, ch, a0, b0);
      const bool second = b0 + HALF < n;
      for (int kb = 0; kb < nk; ++kb) {
        const int it = j * nk + kb, s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], ND * St::A_PLANE + (second ? 2 : 1) * St::B_HALF);
        tma_load_4d(a_stage(s), &ma, &full[s], kb * KB, a0, 0, ch);
        tma_load_4d(b_half(s, 0), &mb, &full[s], kb * KB, b0, 0, ch);
        if (second) tma_load_4d(b_half(s, 1), &mb, &full[s], kb * KB, b0 + HALF, 0, ch);
      }
    }
    return;
  }
  const int h = wg, tl = threadIdx.x % 128;
  const bool lane0 = tl % 32 == 0;
  const int w = tl / 32, g = tl % 32 / 4, t = tl % 4;
  int32_t acc[8 * C];
  for (int j = 0; j < count; ++j) {
    int ch, a0, b0;
    tile(j, ch, a0, b0);
#pragma unroll
    for (int r = 0; r < 8 * C; ++r) acc[r] = 0;
    // the contraction: each stage released once the products reading it
    // have completed (one commit group a stage)
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb) {
      const int it = j * nk + kb, s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint64_t da = swizzled_desc(a_stage(s)), db = swizzled_desc(b_half(s, h));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk)
        window_products<ND>(acc, da + 2 * kk, db + 2 * kk, std::make_integer_sequence<int, ND>{});
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lane0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    if (lane0) mbar_arrive(&empty[prev]);
    fence_regs(acc);

    // the epilogue: output x = 4i + 2r + e of a thread is row 16w + g + 8r,
    // column 8i + 2t + e of its half, column c at acc[8c + x]
    const Fold<C> fold(tables + (size_t)ch * TAB);
    const size_t plane = (size_t)m * n;
    int64_t* o = out + (size_t)ch * plane;
#pragma unroll
    for (int x = 0; x < 8; x += 2) {
      const int row = a0 + 16 * w + g + 8 * (x >> 1 & 1);
      const int col = b0 + HALF * h + 8 * (x >> 2) + 2 * t;
      if (row >= m || col >= n) continue;
      uint64_t res[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int32_t p[C];
#pragma unroll
        for (int c = 0; c < C; ++c) p[c] = acc[8 * c + x + e];
        res[e] = fold(p);
      }
      const size_t at = (size_t)row * n + col;
      if (col + 1 < n && (ch * plane + at) % 2 == 0) {
        *reinterpret_cast<longlong2*>(o + at) = make_longlong2((long long)res[0], (long long)res[1]);
      } else {
        o[at] = (int64_t)res[0];
        if (col + 1 < n) o[at + 1] = (int64_t)res[1];
      }
    }
  }
}

}  // namespace

// Launches on ``stream`` and returns a CUDA error code (0 on success; a
// failed tensor-map encode is cudaErrorInvalidValue). lhs int8 [ch, nd, m,
// k] and rhs int8 [ch, nd, n, k]: the balanced digits of the two residue
// matrices, digit-major, k contiguous, the other strides (bytes) and the
// bases on 16 bytes; tables int64 [ch, 10] and out int64 [ch, m, n],
// contiguous; k * nd * 2^14 < 2^31.
extern "C" int pvw_banded_matmul(const void* lhs, long long lhs_row, long long lhs_plane,
                                 long long lhs_ch, const void* rhs, long long rhs_row,
                                 long long rhs_plane, long long rhs_ch, const void* tables,
                                 void* out, int ch, int m, int n, int k, int nd, void* stream) {
  if (ch <= 0 || m <= 0 || n <= 0 || k <= 0 || nd < 1 || nd > 8 ||
      (long long)k * nd * (1 << 14) >= (1LL << 31) || (long long)m * n > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)ch * ((m + BM2 - 1) / BM2) * ((n + BN2 - 1) / BN2);
  if (total > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const Operand a{lhs, lhs_row, lhs_plane, lhs_ch}, b{rhs, rhs_row, rhs_plane, rhs_ch};
  if (!strides_ok(a, true) || !strides_ok(b, true)) return (int)cudaErrorInvalidValue;
  // A boxes [nd planes x 64 rows x KB k], B boxes [nd planes x 16 columns x
  // KB k], the KB-byte swizzle, zero fill outside
  CUtensorMap ma, mb;
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const cuuint64_t adim[4] = {(cuuint64_t)k, (cuuint64_t)m, (cuuint64_t)nd, (cuuint64_t)ch};
  const cuuint64_t astr[3] = {(cuuint64_t)a.row, (cuuint64_t)a.plane, (cuuint64_t)a.ch};
  const cuuint32_t abox[4] = {KB, BM2, (cuuint32_t)nd, 1};
  const cuuint64_t bdim[4] = {(cuuint64_t)k, (cuuint64_t)n, (cuuint64_t)nd, (cuuint64_t)ch};
  const cuuint64_t bstr[3] = {(cuuint64_t)b.row, (cuuint64_t)b.plane, (cuuint64_t)b.ch};
  const cuuint32_t bbox[4] = {KB, HALF, (cuuint32_t)nd, 1};
  const CUtensorMapSwizzle sw = KB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (encode(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(a.ptr), adim, astr, abox,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(b.ptr), bdim, bstr, bbox,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(total < sms ? total : sms);
  const int nk = (k + KB - 1) / KB;
  cudaStream_t s = (cudaStream_t)stream;
  const auto go = [&](auto kernel, int S, int bytes) -> int {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, THREADS2, bytes, s>>>(ma, mb, (const int64_t*)tables, (int64_t*)out, ch, m, n,
                                        nk, S);
    return (int)cudaGetLastError();
  };
#define PVW_GO(ND) \
  case ND:         \
    return go(banded_matmul_kernel<ND>, stages<ND>(), SLACK + stages<ND>() * Stage<ND>::BYTES);
  switch (nd) {
    PVW_GO(1) PVW_GO(2) PVW_GO(3) PVW_GO(4) PVW_GO(5) PVW_GO(6) PVW_GO(7)
    default: PVW_GO(8)
  }
#undef PVW_GO
}
