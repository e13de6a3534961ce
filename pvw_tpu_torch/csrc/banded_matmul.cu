// Kernel 2: the modular matmul of two residue matrices per channel, by the
// digit convolution, for Hopper (sm_90a).
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
// most of them against zeros). Here the wrapper lays both operands' digits
// out digit-major and k-contiguous, lhs int8 [CH, nd, m, k] and rhs int8
// [CH, nd, n, k], and each of the nd^2 digit pairs (i, j) is one tensor-core
// product accumulated into column i + j: the nd^2 useful products and no
// band. Every output is the canonical residue, so any exact scheme gives the
// TPU kernel's bytes.
//
// What bounds it on an H100: the digit products, nd^2 * m * n * k int8 MACs a
// channel. At [16 ch, 4096 x 256] x [256 x 1024], nd = 5, that is 4.3e11, 0.43
// ms at the int8 tensor-core peak (1,979 TOPS); at config 4's [272 ch, 1024 x
// 512] x [512 x 1024], nd = 8, 9.35e12, 9.45 ms. The residues in and out (8
// bytes each) take 0.21 / 1.36 ms at 3.35 TB/s. So the bound is compute, and
// the contraction is mma.sync m16n8k32 s8 x s8 -> s32.
//
// The design: one block of 8 warps per (channel, 64 x 32 output tile); each
// warp owns a 16 x 16 tile and keeps C x 2 accumulator fragments (120
// registers at nd = 8: the 15 columns are why the tile is half kernel 1's, whose
// 16 warps keep nd x 2). Each step stages 32 k-bytes of the nd lhs and nd rhs
// digit tiles through shared memory (36 KB at nd = 8), the next step's loads
// in flight in registers while the tensor cores run; then each warp reads
// the nd rhs fragments once and, for each lhs digit i, issues the nd products
// into columns i..i+nd-1. The epilogue folds the C int32 columns with up to
// four 64-bit Shoup multiplies (kernel 1's grouped fold, four groups).
// Left for later: wgmma with TMA loads, a deeper stage ring.

#include <cstdint>
#include <cuda_runtime.h>

#include "digit_mma.cuh"

namespace {

using digit_mma::load16;
using digit_mma::mma_s8;

constexpr int BM = 64, BN = 32;                 // output tile
constexpr int THREADS = BM / 16 * (BN / 16) * 32;  // a warp per 16 x 16 tile
constexpr int KT = 32;                          // contraction bytes staged per step
constexpr int SK = KT / 4 + 4;                  // row stride (words): conflict-free fragments
constexpr int CHUNKS = KT / 16;                 // 16-byte chunks of a staged row
constexpr int TAB = 10;                         // per-channel fold table width

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

template <int ND>
__global__ void __launch_bounds__(THREADS, 1)
banded_matmul_kernel(const int8_t* __restrict__ lhs, const int8_t* __restrict__ rhs,
                     const int64_t* __restrict__ tables, int64_t* __restrict__ out,
                     int m, int n, int k) {
  constexpr int C = 2 * ND - 1;
  constexpr int A_TASKS = ND * BM * CHUNKS, TASKS = ND * (BM + BN) * CHUNKS;
  constexpr int PER = (TASKS + THREADS - 1) / THREADS;
  __shared__ __align__(16) uint32_t sA[ND * BM * SK];
  __shared__ __align__(16) uint32_t sB[ND * BN * SK];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, ch = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                 // mma fragment coordinates
  const int wm = warp % (BM / 16) * 16, wn = warp / (BM / 16) * 16;  // the warp's tile
  const int8_t* A = lhs + (size_t)ch * ND * m * k;      // [ND, m, k]
  const int8_t* B = rhs + (size_t)ch * ND * n * k;      // [ND, n, k]
  const bool vecA = k % 16 == 0 && (reinterpret_cast<uintptr_t>(lhs) & 15) == 0;
  const bool vecB = k % 16 == 0 && (reinterpret_cast<uintptr_t>(rhs) & 15) == 0;

  int32_t acc[C][2][4];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0;

  // staging task: 16 k-bytes of one row of one digit plane, lhs tasks first
  uint4 r[PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int task = tid + p * THREADS;
      if (task >= TASKS) continue;
      const int kk = k0 + 16 * (task % CHUNKS);
      if (task < A_TASKS) {
        const int i = task / (BM * CHUNKS), row = task / CHUNKS % BM;
        r[p] = load16(A + ((size_t)i * m + m0 + row) * k + kk,
                      m0 + row < m ? (long long)k - kk : 0, vecA);
      } else {
        const int bt = task - A_TASKS;
        const int j = bt / (BN * CHUNKS), col = bt / CHUNKS % BN;
        r[p] = load16(B + ((size_t)j * n + n0 + col) * k + kk,
                      n0 + col < n ? (long long)k - kk : 0, vecB);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int task = tid + p * THREADS;
      if (task >= TASKS) continue;
      const int q4 = 4 * (task % CHUNKS);
      if (task < A_TASKS)
        *reinterpret_cast<uint4*>(&sA[(task / CHUNKS) * SK + q4]) = r[p];
      else
        *reinterpret_cast<uint4*>(&sB[((task - A_TASKS) / CHUNKS) * SK + q4]) = r[p];
    }
  };

  load(0);
  for (int k0 = 0; k0 < k; k0 += KT) {
    store();
    __syncthreads();
    if (k0 + KT < k) load(k0 + KT);  // in flight while the tensor cores run
    uint32_t bf[ND][2][2];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const uint32_t* b = sB + (j * BN + wn + 8 * f + g) * SK + t;
        bf[j][f][0] = b[0];
        bf[j][f][1] = b[4];
      }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const uint32_t* a = sA + (i * BM + wm + g) * SK + t;
      const uint32_t a0 = a[0], a1 = a[8 * SK], a2 = a[4], a3 = a[8 * SK + 4];
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int f = 0; f < 2; ++f)
          mma_s8(acc[i + j][f], a0, a1, a2, a3, bf[j][f][0], bf[j][f][1]);
    }
    __syncthreads();
  }

  const Fold<C> fold(tables + (size_t)ch * TAB);
  const size_t plane = (size_t)m * n;
  // accumulator e of fragment f: row g (+8 for e >= 2), column 2t (+1 for odd e)
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + wm + g + 8 * (e >> 1), col = n0 + wn + 8 * f + 2 * t + (e & 1);
      if (row >= m || col >= n) continue;
      int32_t p[C];
#pragma unroll
      for (int c = 0; c < C; ++c) p[c] = acc[c][f][e];
      out[(size_t)ch * plane + (size_t)row * n + col] = (int64_t)fold(p);
    }
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
// lhs int8 [ch, nd, m, k] and rhs int8 [ch, nd, n, k]: the balanced digits of
// the two residue matrices, digit-major, k contiguous; tables int64 [ch, 10];
// out int64 [ch, m, n]. All arrays contiguous; k * nd * 2^14 < 2^31.
extern "C" int pvw_banded_matmul(const void* lhs, const void* rhs, const void* tables,
                                 void* out, int ch, int m, int n, int k, int nd,
                                 void* stream) {
  if (ch <= 0 || ch > 65535 || m <= 0 || n <= 0 || k <= 0 || nd < 1 || nd > 8 ||
      (long long)k * nd * (1 << 14) >= (1LL << 31) || (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, ch);
  cudaStream_t s = (cudaStream_t)stream;
  const auto go = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>((const int8_t*)lhs, (const int8_t*)rhs,
                                    (const int64_t*)tables, (int64_t*)out, m, n, k);
  };
  switch (nd) {
    case 1: go(banded_matmul_kernel<1>); break;
    case 2: go(banded_matmul_kernel<2>); break;
    case 3: go(banded_matmul_kernel<3>); break;
    case 4: go(banded_matmul_kernel<4>); break;
    case 5: go(banded_matmul_kernel<5>); break;
    case 6: go(banded_matmul_kernel<6>); break;
    case 7: go(banded_matmul_kernel<7>); break;
    default: go(banded_matmul_kernel<8>); break;
  }
  return (int)cudaGetLastError();
}
