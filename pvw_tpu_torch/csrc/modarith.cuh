// Helpers shared by the port's kernels: modular arithmetic on native 64-bit
// integers (every modulus of the scheme is below 2^62; residues are
// canonical in [0, q)) and a 4 x 4 byte transpose.

#pragma once

#include <cstdint>

__device__ __forceinline__ uint64_t shoup(uint64_t x, uint64_t w, uint64_t wp,
                                          uint64_t q) {
  // w * x mod q for any x < 2^64, w < q < 2^62, wp = floor(w * 2^64 / q)
  uint64_t t = __umul64hi(wp, x);
  uint64_t r = w * x - t * q;  // in [0, 2q)
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint64_t addmod(uint64_t a, uint64_t b, uint64_t q) {
  uint64_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint64_t submod(uint64_t a, uint64_t b, uint64_t q) {
  return a >= b ? a - b : a + q - b;
}

// Transposes the bytes of four words: out[j] byte c = byte j of in[c].
__device__ __forceinline__ void transpose_bytes(const uint32_t in[4], uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);  // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(in[2], in[3], 0x5140);  // c0 d0 c1 d1
  const uint32_t t2 = __byte_perm(in[0], in[1], 0x7362);  // a2 b2 a3 b3
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);  // c2 d2 c3 d3
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}
