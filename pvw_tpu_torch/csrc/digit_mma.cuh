// Pieces shared by the fused matmul kernels (fused_scaled_noise_matmul.cu and
// fused_pipelined_matmul.cu): the int8 tensor-core contraction of balanced
// digit planes, staged through shared memory, and the exact fold of nd int32
// columns to a canonical residue with the gadget encode.
//
// The contraction of one (channel, BM x BN output tile) leaves nd int32
// columns per output in registers: acc[c][j][e] is column c of accumulator e
// of the warp's n-fragment j (mma.sync m16n8k32 s8 x s8 -> s32; each warp owns
// a 16 x 16 tile). Two operand forms:
//
// - banded (kernel 1): lhs rows int8 [m, kd] (k contiguous, the A layout) and
//   the scaled band int8 [nd, kd, n], n contiguous, byte-transposed on its way
//   into shared memory (four k rows of 16 columns loaded as 16-byte vectors,
//   their bytes transposed so that each 32-bit word holds four k of one
//   column, the B layout). Column c = lhs . band plane c.
// - swapped (kernel 1's swapped variant): nd scaled lhs planes int8
//   [nd, m, kd] and the plain rhs digits laid out k-packed, int8 [n, kd]; both
//   operands are k-contiguous rows, staged as they lie. Column c = lhs plane c
//   . rhs, the one rhs tile shared by every column.
//
// In both, the next step's global loads are in flight in registers while the
// tensor cores work on the current one; shared rows are padded so that the
// fragment reads hit 32 distinct banks.

#pragma once

#include <cstdint>

#include "modarith.cuh"

namespace digit_mma {

constexpr int KT = 64;       // contraction bytes staged per step
constexpr int KW = KT / 4;   // packed 32-bit words per staged row
constexpr int SK = KW + 4;   // row stride (words) of a k-contiguous tile
constexpr int TAB = 8;       // per-channel fold table width

// 16 bytes at p, zero from byte ``avail`` on; one vector load when allowed.
__device__ __forceinline__ uint4 load16(const int8_t* p, long long avail, bool vec) {
  if (vec && avail >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < avail) w[b / 4] |= (uint32_t)(uint8_t)p[b] << (8 * (b % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int ND>
__device__ __forceinline__ void zero_acc(int32_t (&acc)[ND][2][4]) {
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0;
}

// Shared words of the banded form's staging tiles.
template <int ND, int BM, int BN>
struct BandedSmem {
  static constexpr int SB = BN + 8;  // sB row stride (words): conflict-free B fragments
  static constexpr int A_WORDS = BM * SK;
  static constexpr int B_WORDS = ND * KW * SB;
};

// acc += lhs[m0.., :] . band[c, :, n0..] for every plane c; A = the channel's
// lhs [m, kd], B = its band [ND, kd, n]. NT threads (ids ``tid`` from 0), one
// warp per 16 x 16 tile; ``sync`` is a barrier of those NT threads.
template <int ND, int BM, int BN, int NT, class Sync>
__device__ __forceinline__ void contract_banded(const int8_t* __restrict__ A,
                                                const int8_t* __restrict__ B, int m,
                                                int n, int kd, int m0, int n0, int tid,
                                                bool vecA, bool vecB, uint32_t* sA,
                                                uint32_t* sB, int32_t (&acc)[ND][2][4],
                                                Sync sync) {
  constexpr int SB = BandedSmem<ND, BM, BN>::SB;
  constexpr int A_TASKS = BM * KT / 16;      // 16-byte lhs chunks a step
  constexpr int B_TASKS = KW * (BN / 16);    // 4 x 16-byte band chunks a plane
  static_assert(NT == BM / 16 * (BN / 16) * 32, "a warp per 16 x 16 tile");
  static_assert(A_TASKS <= NT && ND * B_TASKS <= NT, "one staging task a thread");
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % (BM / 16) * 16, wn = warp / (BM / 16) * 16;
  // staging tasks: A, 16 k-bytes of one row; B, four k rows x 16 columns of
  // one plane
  const int a_row = tid / (KT / 16), a_kq = tid % (KT / 16);
  const int b_nq = tid % (BN / 16), b_kw = (tid / (BN / 16)) % KW;
  const int b_c = tid / B_TASKS;
  const bool a_task = tid < A_TASKS, b_task = b_c < ND;
  uint4 ra, rb[4];
  auto load = [&](int k0) {
    const int ka = k0 + 16 * a_kq;
    if (a_task)
      ra = load16(A + (size_t)(m0 + a_row) * kd + ka,
                  m0 + a_row < m ? (long long)kd - ka : 0, vecA);
    if (b_task) {
      const int col = n0 + 16 * b_nq;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + 4 * b_kw + r;
        rb[r] = load16(B + ((size_t)b_c * kd + k) * n + col,
                       k < kd ? (long long)n - col : 0, vecB);
      }
    }
  };
  auto store = [&]() {
    if (a_task) *reinterpret_cast<uint4*>(&sA[a_row * SK + 4 * a_kq]) = ra;
    if (b_task) {
      const uint32_t x[4] = {rb[0].x, rb[1].x, rb[2].x, rb[3].x};
      const uint32_t y[4] = {rb[0].y, rb[1].y, rb[2].y, rb[3].y};
      const uint32_t z[4] = {rb[0].z, rb[1].z, rb[2].z, rb[3].z};
      const uint32_t w[4] = {rb[0].w, rb[1].w, rb[2].w, rb[3].w};
      uint32_t o[16];
      transpose_bytes(x, o);
      transpose_bytes(y, o + 4);
      transpose_bytes(z, o + 8);
      transpose_bytes(w, o + 12);
      uint4* dst = reinterpret_cast<uint4*>(&sB[(b_c * KW + b_kw) * SB + 16 * b_nq]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[q] = make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    }
  };

  load(0);
  for (int k0 = 0; k0 < kd; k0 += KT) {
    store();
    sync();
    if (k0 + KT < kd) load(k0 + KT);  // in flight while the tensor cores run
#pragma unroll
    for (int ks = 0; ks < KW; ks += 8) {
      const uint32_t a0 = sA[(wm + g) * SK + ks + t];
      const uint32_t a1 = sA[(wm + g + 8) * SK + ks + t];
      const uint32_t a2 = sA[(wm + g) * SK + ks + 4 + t];
      const uint32_t a3 = sA[(wm + g + 8) * SK + ks + 4 + t];
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t* b = sB + (c * KW + ks + t) * SB + wn + 8 * j + g;
          mma_s8(acc[c][j], a0, a1, a2, a3, b[0], b[4 * SB]);
        }
    }
    sync();
  }
}

// Shared words of the swapped form's staging tiles.
template <int ND, int BM, int BN>
struct SwappedSmem {
  static constexpr int A_WORDS = ND * BM * SK;
  static constexpr int B_WORDS = BN * SK;
};

// acc[c] += lhs[c, m0.., :] . rhs[n0.., :]^T for every plane c; A = the
// channel's scaled lhs planes [ND, m, kd], B = its plain rhs digits k-packed
// [n, kd]. Same threads, warps and barrier as contract_banded.
template <int ND, int BM, int BN, int NT, class Sync>
__device__ __forceinline__ void contract_swapped(const int8_t* __restrict__ A,
                                                 const int8_t* __restrict__ B, int m,
                                                 int n, int kd, int m0, int n0, int tid,
                                                 bool vecA, bool vecB, uint32_t* sA,
                                                 uint32_t* sB, int32_t (&acc)[ND][2][4],
                                                 Sync sync) {
  constexpr int CHUNKS = KT / 16;                    // 16-byte chunks of a staged row
  constexpr int A_TASKS = ND * BM * CHUNKS;
  constexpr int A_PER = (A_TASKS + NT - 1) / NT;
  constexpr int B_TASKS = BN * CHUNKS;
  static_assert(NT == BM / 16 * (BN / 16) * 32, "a warp per 16 x 16 tile");
  static_assert(B_TASKS <= NT, "one rhs staging task a thread");
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % (BM / 16) * 16, wn = warp / (BM / 16) * 16;
  const size_t plane = (size_t)m * kd;
  uint4 ra[A_PER], rb;
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int task = tid + i * NT;
      if (task < A_TASKS) {
        const int c = task / (BM * CHUNKS), row = task / CHUNKS % BM;
        const int ka = k0 + 16 * (task % CHUNKS);
        ra[i] = load16(A + c * plane + (size_t)(m0 + row) * kd + ka,
                       m0 + row < m ? (long long)kd - ka : 0, vecA);
      }
    }
    if (tid < B_TASKS) {
      const int col = tid / CHUNKS, kb = k0 + 16 * (tid % CHUNKS);
      rb = load16(B + (size_t)(n0 + col) * kd + kb,
                  n0 + col < n ? (long long)kd - kb : 0, vecB);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int task = tid + i * NT;
      if (task < A_TASKS) {
        const int c = task / (BM * CHUNKS), row = task / CHUNKS % BM;
        *reinterpret_cast<uint4*>(&sA[(c * BM + row) * SK + 4 * (task % CHUNKS)]) = ra[i];
      }
    }
    if (tid < B_TASKS)
      *reinterpret_cast<uint4*>(&sB[(tid / CHUNKS) * SK + 4 * (tid % CHUNKS)]) = rb;
  };

  load(0);
  for (int k0 = 0; k0 < kd; k0 += KT) {
    store();
    sync();
    if (k0 + KT < kd) load(k0 + KT);  // in flight while the tensor cores run
#pragma unroll
    for (int ks = 0; ks < KW; ks += 8) {
      uint32_t b0[2], b1[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t* b = sB + (wn + 8 * j + g) * SK + ks + t;
        b0[j] = b[0];
        b1[j] = b[4];
      }
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const uint32_t* a = sA + (c * BM + wm + g) * SK + ks + t;
        const uint32_t a0 = a[0], a1 = a[8 * SK], a2 = a[4], a3 = a[8 * SK + 4];
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_s8(acc[c][j], a0, a1, a2, a3, b0[j], b1[j]);
      }
    }
    sync();
  }
}

// Per-channel fold constants, from tables [CH, TAB] int64: q, bias K
// (sum_c 2^31 * 2^(8c) mod q), then (w_g, w_g') for the groups g = 0, 1 of four
// columns: w_g = 2^(32g) mod q and its 64-bit Shoup companion.
struct Fold {
  uint64_t q, bias, w0, wp0, w1, wp1;
  __device__ __forceinline__ explicit Fold(const int64_t* T)
      : q((uint64_t)T[0]), bias((uint64_t)T[1]), w0((uint64_t)T[2]),
        wp0((uint64_t)T[3]), w1((uint64_t)T[4]), wp1((uint64_t)T[5]) {}

  // exact fold of nd int32 columns: bias each by 2^31, group four per u64
  template <int ND>
  __device__ __forceinline__ uint64_t operator()(const int32_t (&p)[ND]) const {
    uint64_t G0 = 0, G1 = 0;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const uint64_t u = (uint64_t)((uint32_t)p[c] ^ 0x80000000u);
      if (c < 4) G0 += u << (8 * c);
      else G1 += u << (8 * (c - 4));
    }
    uint64_t res = shoup(G0, w0, wp0, q);
    if (ND > 4) res = addmod(res, shoup(G1, w1, wp1, q), q);
    return submod(res, bias, q);
  }
};

// Per-channel gadget-encode constants, from etab [CH, 3] int64: g, g',
// (2^64 mod q)*g mod q (zero without an encode, E null).
struct Encode {
  uint64_t g = 0, gs = 0, wrap = 0;
  __device__ __forceinline__ explicit Encode(const int64_t* E) {
    if (E != nullptr) g = (uint64_t)E[0], gs = (uint64_t)E[1], wrap = (uint64_t)E[2];
  }

  // encode(s)*g mod q for the u64 scalar s, read as the reference's `as i64`
  // (encryption.rs:195: s >= 2^63 encodes s - 2^64); ``encode32``: s < 2^32
  __device__ __forceinline__ uint64_t operator()(uint64_t s, bool encode32,
                                                 uint64_t q) const {
    if (encode32) return shoup(s & 0xFFFFFFFFull, g, gs, q);
    const uint64_t enc = shoup(s, g, gs, q);
    return (s >> 63) ? submod(enc, wrap, q) : enc;
  }
};

}  // namespace digit_mma
