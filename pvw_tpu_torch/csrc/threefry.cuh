// Threefry-2x32-20 and the "stream v3k" value construction, on uint32_t
// throughout (every add, shift and counter wraps mod 2^32, as the contract's
// u32 arithmetic does).
//
// The contract (pvw_tpu_torch/ops/tfry.py, the plain version): the noise value
// at (global row g, global column c, coefficient jj = 2*jjp + parity) of a ring
// of degree l is drawn from three evaluations
//
//   (y0, y1)_t = Threefry-2x32-20(key, (g, ((c*(l/2) + jjp) << 2) | t)),  t = 0, 1, 2
//
// coefficient 2*jjp takes the y0 words, 2*jjp + 1 the y1 words, and the value
// is floor(x96 * (2*bound + 1) / 2^96) - bound with x96 = w_0*2^64 + w_1*2^32 + w_2.

#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// One Threefry-2x32 evaluation, 20 rounds (five groups of four, a key
// injection after each group), bit-identical to JAX's threefry_2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                             uint32_t x1, uint32_t& y0, uint32_t& y1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = i % 2 == 0 ? 13 : 17, r1 = i % 2 == 0 ? 15 : 29;
    const int r2 = i % 2 == 0 ? 26 : 16, r3 = i % 2 == 0 ? 6 : 24;
    x0 += x1; x1 = rotl32(x1, r0) ^ x0;
    x0 += x1; x1 = rotl32(x1, r1) ^ x0;
    x0 += x1; x1 = rotl32(x1, r2) ^ x0;
    x0 += x1; x1 = rotl32(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// floor(x96 * rng / 2^96) for x96 = hi*2^64 + mid*2^32 + lo and rng < 2^31:
// exact, each partial product plus the carry below 2^63.
__device__ __forceinline__ uint32_t reduce96(uint32_t hi, uint32_t mid, uint32_t lo,
                                             uint32_t rng) {
  uint64_t t = ((uint64_t)lo * rng) >> 32;
  t = ((uint64_t)mid * rng + t) >> 32;
  return (uint32_t)(((uint64_t)hi * rng + t) >> 32);
}

// Signed value -> (d0, d1) balanced 8-bit digits, v == d0 + 256*d1.
__device__ __forceinline__ void digit_split(int32_t v, int32_t& d0, int32_t& d1) {
  d0 = ((v + 128) & 255) - 128;
  d1 = (v - d0) >> 8;
}
