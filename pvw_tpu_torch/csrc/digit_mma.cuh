// Pieces shared by the fused matmul kernels on wgmma (wgmma_digit.cuh): the
// 16-byte load of their noise staging, and the exact fold of nd int32
// columns to a canonical residue with the gadget encode, which kernels 1 and
// 3 run in their epilogues.

#pragma once

#include <cstdint>

#include "modarith.cuh"

namespace digit_mma {

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
