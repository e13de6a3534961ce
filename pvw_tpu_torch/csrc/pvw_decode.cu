// The PVW sequential-rounding decode, one warp a message, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's batched decode is XLA code
// (pvw_tpu/crypto/device_decode.py, two lax.scan loops over l). It writes
// exactly what pvw_tpu_torch/crypto/device_decode.py::decode_residues_plain
// returns: for canonical PowerBasis residues z [d, L, l] (int64) the d
// messages as u64 bit patterns, by the exact multiprecision decode of
// decode_scalar_pvw_rns (decryption.rs:10-58, the clamp of :226-247):
//
//   tmp[i] = z[i]*Δ - z[i+1] and the Horner fold, mod each q_j;
//   the fold lifted (CRT), centred (strict > q/2), reduced to the centred
//   remainder mod Δ^(l-1), back to RNS;
//   for i = l-2 .. 0: (noise - tmp[i]) lifted, centred, (2|a| + Δ) / 2Δ
//   truncated with a's sign, back to RNS;
//   -(z[0] + noise[0]) mod q, centred, clamped (a negative value with
//   |v| <= 1000 gives 0, so does a value >= 2^64).
//
// Both divisions are by static constants, by the plan's reciprocal R =
// floor(2^(32 fw) / D): t = floor(N * R / 2^(32 fw)) is at most one below
// floor(N / D) for N < 2^(32 fw), so one conditional step makes quotient
// and remainder exact (pvw_tpu_torch/ops/mw.py::StaticDivisor).
//
// What bounds it on an H100: not the 2.0 MB of residues read at config 4's
// batch (d = 921, L = 17, l = 16, W = 33: 0.6 us at 3.35 TB/s) nor its
// multiply-adds (about 8e7, chip_smoke.decode_madds: 5 us at the measured
// IMAD rate) but the chain of l dependent steps a message, each a lift, a
// division and a conversion whose carries cross every word (0.16 ms raw on
// an H100 80GB HBM3 at 700 W). The plain twin runs each step
// as dozens of tensor ops over the batch: some 3,000-6,000 launches a decode.
// Here a warp owns a message and keeps the chain in registers: lane j holds
// limb j for the RNS steps (L <= 32); a multiword magnitude (W <= 64 words
// of 32 bits) lies lane w -> words w and w + 32 (NB = 1 or 2 registers a
// lane, by template on W); a lift's or a product's column sums are each
// lane's own column (one 32 x 32 -> 64-bit product a term, the low and high
// halves summed apart, every sum below 2^39), the carries resolved by one
// 33-bit addition of the warp's generate / propagate ballots (as ops/mw.py
// does on packed int64 masks); comparisons are two ballots. The plan's
// tables (moduli, Shoup companions, qhat's words, 2^(32w) mod q_j, the
// multiples j*q, both divisors' R and D) are copied once a block into
// shared memory; a product's columns go through a per-warp scratch of 256
// words. No intermediate reaches device memory, nothing is allocated, and
// 921 messages are 921 warps in blocks of four: about seven a SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint64_t M32 = 0xFFFFFFFFull;
constexpr int WARPS = 4;                      // messages a block
constexpr int MAX_LIMBS = 32, MAX_ELL = 32, MAX_WORDS = 64;
// a warp's scratch, 32-bit words: a numerator [64], a product's columns
// [128] (N * R needs fw + nq <= 2W), the product t * D [64]
constexpr int SCR_N = 0, SCR_P = 64, SCR_T = 192, SCRATCH = 256;

// The plan's sizes, in the order of the C entry's dims array.
struct Dims {
  int L, ell, W, nwq;          // limbs, ring degree, magnitude words, words of q
  int m_fw, m_nr, m_nd, m_nq;  // the centred remainder's divisor Δ^(l-1)
  int v_fw, v_nr, v_nd, v_nq;  // the rounding division's divisor 2Δ
};

struct Divisor {
  int fw, nr, nd, nq;          // numerator words, words of R, D and the quotient
  const uint64_t *r, *d;
};

// Views of the packed table block (one int64 an entry; multiword constants
// a 32-bit word an entry), in the order device_decode.kernel_block packs it.
struct Plan {
  int L, ell, W, nwq;
  const uint64_t *q, *qinv, *qinv_sh, *dl, *dl_sh;   // [L] each
  const uint64_t *p32, *p32_sh;                      // [L, W]: 2^(32w) mod q_j, 32-bit Shoup
  const uint64_t *qhat;                              // [L, nwq] words of q / q_j
  const uint64_t *q_words, *half_q;                  // [W]
  const uint64_t *q_mult;                            // [L, W] words of j*q
  const uint64_t *half_m, *delta;                    // [m_nd], [v_fw]
  Divisor mod, div;
};

__host__ __device__ inline int table_len(const Dims& D) {
  return 5 * D.L + 3 * D.L * D.W + D.L * D.nwq + 2 * D.W + D.m_nr + 2 * D.m_nd + D.v_nr +
         D.v_nd + D.v_fw;
}

__device__ __forceinline__ Plan make_plan(const uint64_t* t, const Dims& D) {
  Plan P;
  P.L = D.L; P.ell = D.ell; P.W = D.W; P.nwq = D.nwq;
  P.q = t; t += D.L;
  P.qinv = t; t += D.L;
  P.qinv_sh = t; t += D.L;
  P.dl = t; t += D.L;
  P.dl_sh = t; t += D.L;
  P.p32 = t; t += D.L * D.W;
  P.p32_sh = t; t += D.L * D.W;
  P.qhat = t; t += D.L * D.nwq;
  P.q_words = t; t += D.W;
  P.half_q = t; t += D.W;
  P.q_mult = t; t += D.L * D.W;
  P.mod = {D.m_fw, D.m_nr, D.m_nd, D.m_nq, t, t + D.m_nr}; t += D.m_nr + D.m_nd;
  P.half_m = t; t += D.m_nd;
  P.div = {D.v_fw, D.v_nr, D.v_nd, D.v_nq, t, t + D.v_nr}; t += D.v_nr + D.v_nd;
  P.delta = t;
  return P;
}

// --------------------------------------------------------------------------
// a magnitude across the warp: word w in lane w % 32, register w / 32
// --------------------------------------------------------------------------

template <int NB>
struct Num {
  uint32_t w[NB];
};

// The warp's flags of every word as one mask, bit w = word w's flag.
template <int NB>
__device__ __forceinline__ uint64_t ballot_words(const uint32_t (&f)[NB]) {
  uint64_t m = 0;
#pragma unroll
  for (int s = 0; s < NB; ++s) m |= (uint64_t)__ballot_sync(FULL, f[s] != 0) << (32 * s);
  return m;
}

// The carries into each word of a chain with exclusive generate and
// propagate masks and a carry into word 0: bit w of (G + (G | P) + c) ^ P.
__device__ __forceinline__ uint64_t carries(uint64_t G, uint64_t P, uint64_t cin) {
  return (G + (G | P) + cin) ^ P;
}

__device__ __forceinline__ uint32_t bit_of(uint64_t mask, int s, int lane) {
  return (uint32_t)(mask >> (32 * s + lane)) & 1u;
}

template <int NB, typename T>
__device__ __forceinline__ Num<NB> num_load(const T* src, int nw, int lane) {
  Num<NB> r;
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    const int i = 32 * s + lane;
    r.w[s] = i < nw ? (uint32_t)src[i] : 0u;
  }
  return r;
}

template <int NB>
__device__ __forceinline__ void num_store(const Num<NB>& x, uint32_t* dst, int lane) {
#pragma unroll
  for (int s = 0; s < NB; ++s) dst[32 * s + lane] = x.w[s];
}

// (x > y, x < y): the larger of the two word masks holds the top differing word.
template <int NB>
__device__ __forceinline__ bool num_gt(const Num<NB>& x, const Num<NB>& y) {
  uint32_t g[NB], l[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    g[s] = x.w[s] > y.w[s];
    l[s] = x.w[s] < y.w[s];
  }
  return ballot_words<NB>(g) > ballot_words<NB>(l);
}

template <int NB>
__device__ __forceinline__ bool num_ge(const Num<NB>& x, const Num<NB>& y) {
  return !num_gt(y, x);
}

template <int NB>
__device__ __forceinline__ bool num_zero(const Num<NB>& x) {
  uint32_t nz[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) nz[s] = x.w[s] != 0;
  return ballot_words<NB>(nz) == 0;
}

// x + y + c0 (c0 into word 0), mod 2^(32 * 32 NB).
template <int NB>
__device__ __forceinline__ Num<NB> num_add(const Num<NB>& x, const Num<NB>& y, int lane,
                                           uint32_t c0 = 0) {
  uint32_t g[NB], p[NB], w[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    const uint64_t sum = (uint64_t)x.w[s] + y.w[s];
    w[s] = (uint32_t)sum;
    g[s] = (uint32_t)(sum >> 32);
    p[s] = w[s] == FULL;
  }
  const uint64_t c = carries(ballot_words<NB>(g), ballot_words<NB>(p), c0);
  Num<NB> r;
#pragma unroll
  for (int s = 0; s < NB; ++s) r.w[s] = w[s] + bit_of(c, s, lane);
  return r;
}

// x - y for x >= y: a borrow is generated where x_w < y_w and passes a word
// where x_w == y_w.
template <int NB>
__device__ __forceinline__ Num<NB> num_sub(const Num<NB>& x, const Num<NB>& y, int lane) {
  uint32_t g[NB], p[NB], w[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    w[s] = x.w[s] - y.w[s];
    g[s] = x.w[s] < y.w[s];
    p[s] = w[s] == 0;
  }
  const uint64_t b = carries(ballot_words<NB>(g), ballot_words<NB>(p), 0);
  Num<NB> r;
#pragma unroll
  for (int s = 0; s < NB; ++s) r.w[s] = w[s] - bit_of(b, s, lane);
  return r;
}

// --------------------------------------------------------------------------
// column sums: lane c of a block of 32 columns holds column c's sums of the
// low halves (a0) and of the high halves (a1, which belong to column c + 1)
// --------------------------------------------------------------------------

struct Chain {
  uint64_t a1;   // a1 of the column below the block
  uint32_t vh;   // the part above 32 bits of that column's value
  uint32_t cin;  // the carry out of the block below
};

// The normalized word of column c = base + lane, given every lane's (a0, a1)
// of this block (each below 2^38): v_c = a0_c + a1_(c-1) (< 2^39), then
// u_c = v_c mod 2^32 + (v_(c-1) >> 32) (at most one carry out), the carries
// resolved by one addition of the ballots.
__device__ __forceinline__ uint32_t resolve(uint64_t a0, uint64_t a1, Chain& ch, int lane) {
  uint64_t a1_below = __shfl_up_sync(FULL, a1, 1);
  if (lane == 0) a1_below = ch.a1;
  ch.a1 = __shfl_sync(FULL, a1, 31);
  const uint64_t v = a0 + a1_below;
  const uint32_t vh = (uint32_t)(v >> 32);
  uint32_t vh_below = __shfl_up_sync(FULL, vh, 1);
  if (lane == 0) vh_below = ch.vh;
  ch.vh = __shfl_sync(FULL, vh, 31);
  const uint64_t u = (v & M32) + vh_below;
  const uint32_t w = (uint32_t)u;
  const uint32_t G = __ballot_sync(FULL, (u >> 32) != 0);
  const uint32_t P = __ballot_sync(FULL, w == FULL);
  const uint64_t S = (uint64_t)G + (G | P) + ch.cin;
  ch.cin = (uint32_t)(S >> 32);
  return w + (uint32_t)(((S ^ P) >> lane) & 1u);
}

// out[c] for c < ncols: the words of a * b mod 2^(32 ncols), a [na] read by
// every lane at once, b [nb] at each lane's own column; na <= 64.
template <typename TA, typename TB>
__device__ __forceinline__ void mul_cols(const TA* a, int na, const TB* b, int nb, int ncols,
                                         uint32_t* out, int lane) {
  Chain ch{0, 0, 0};
  for (int base = 0; base < ncols; base += 32) {
    const int c = base + lane;
    uint64_t a0 = 0, a1 = 0;
    for (int i = 0; i < na; ++i) {
      const int j = c - i;
      if (j >= 0 && j < nb) {
        const uint64_t p = (uint64_t)(uint32_t)a[i] * (uint32_t)b[j];
        a0 += p & M32;
        a1 += p >> 32;
      }
    }
    const uint32_t w = resolve(a0, a1, ch, lane);
    if (c < ncols) out[c] = w;
  }
  __syncwarp();
}

// --------------------------------------------------------------------------
// the decode's steps
// --------------------------------------------------------------------------

// CRT lift of limb residue r (lane j < L holds limb j) to its canonical
// magnitude in [0, q): sum_j ((r_j * qhat_inv_j) mod q_j) * qhat_j (< L q;
// each x_j as two 32-bit words against qhat_j's words), then floor(acc / q)
// found among the multiples j*q by binary lifting, and taken off.
template <int NB>
__device__ Num<NB> lift(uint64_t r, const Plan& P, int lane) {
  uint64_t x = 0;
  if (lane < P.L) x = shoup(r, P.qinv[lane], P.qinv_sh[lane], P.q[lane]);
  Num<NB> acc;
  Chain ch{0, 0, 0};
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    const int c = 32 * s + lane;
    uint64_t a0 = 0, a1 = 0;
    for (int j = 0; j < P.L; ++j) {
      const uint64_t xj = __shfl_sync(FULL, x, j);
      const uint64_t* qh = P.qhat + j * P.nwq;
      if (c < P.nwq) {
        const uint64_t p = (xj & M32) * (uint32_t)qh[c];
        a0 += p & M32;
        a1 += p >> 32;
      }
      if (c >= 1 && c <= P.nwq) {
        const uint64_t p = (xj >> 32) * (uint32_t)qh[c - 1];
        a0 += p & M32;
        a1 += p >> 32;
      }
    }
    acc.w[s] = resolve(a0, a1, ch, lane);
  }
  int k = 0;
  for (int step = 16; step; step >>= 1)
    if (k + step < P.L && num_ge(acc, num_load<NB>(P.q_mult + (k + step) * P.W, P.W, lane)))
      k += step;
  return num_sub(acc, num_load<NB>(P.q_mult + k * P.W, P.W, lane), lane);
}

// Canonical a in [0, q) -> |a| with the STRICT > q/2 rule; returns a < 0.
template <int NB>
__device__ __forceinline__ bool center(Num<NB>& a, const Plan& P, int lane) {
  const bool neg = num_gt(a, num_load<NB>(P.half_q, P.W, lane));
  if (neg) a = num_sub(num_load<NB>(P.q_words, P.W, lane), a, lane);
  return neg;
}

// floor(N / D) and N mod D for N < 2^(32 fw): t = words [fw, fw + nq) of
// N * R, r = N - t * D (below 2D), one conditional step.
template <int NB>
__device__ void divmod(const Num<NB>& num, const Divisor& dv, uint32_t* scr, int lane,
                       Num<NB>* quo, Num<NB>* rem) {
  uint32_t *sn = scr + SCR_N, *sp = scr + SCR_P, *st = scr + SCR_T;
  num_store(num, sn, lane);
  __syncwarp();
  mul_cols(dv.r, dv.nr, sn, dv.fw, dv.fw + dv.nq, sp, lane);
  const uint32_t* t = sp + dv.fw;
  if (dv.nq <= dv.nd)
    mul_cols(t, dv.nq, dv.d, dv.nd, dv.fw, st, lane);
  else
    mul_cols(dv.d, dv.nd, t, dv.nq, dv.fw, st, lane);
  const Num<NB> r = num_sub(num, num_load<NB>(st, dv.fw, lane), lane);
  const Num<NB> d = num_load<NB>(dv.d, dv.nd, lane);
  const bool ge = num_ge(r, d);
  if (quo) *quo = num_add(num_load<NB>(t, dv.nq, lane), Num<NB>{}, lane, ge);
  if (rem) *rem = ge ? num_sub(r, d, lane) : r;
  __syncwarp();
}

// A sign-magnitude value of nw words -> its residue mod q_j in lane j: each
// word times 2^(32w) mod q_j by a 32-bit Shoup product, summed mod q_j.
template <int NB>
__device__ uint64_t to_rns(const Num<NB>& v, bool neg, int nw, const Plan& P, int lane) {
  const bool live = lane < P.L;
  const uint64_t q = live ? P.q[lane] : 0;
  const uint64_t* p32 = P.p32 + (live ? lane : 0) * P.W;
  const uint64_t* p32_sh = P.p32_sh + (live ? lane : 0) * P.W;
  uint64_t acc = 0;
  for (int w = 0; w < nw; ++w) {
    const uint32_t vw = __shfl_sync(FULL, w < 32 ? v.w[0] : v.w[NB - 1], w & 31);
    if (live) {
      const uint64_t t = (p32_sh[w] * vw) >> 32;
      uint64_t r = p32[w] * vw - t * q;
      if (r >= q) r -= q;
      acc = addmod(acc, r, q);
    }
  }
  return neg && acc ? q - acc : acc;
}

template <int NB>
__global__ void __launch_bounds__(32 * WARPS)
decode_kernel(const uint64_t* __restrict__ res, int d, Dims dims,
              const uint64_t* __restrict__ tab, uint64_t* __restrict__ out) {
  extern __shared__ uint64_t smem[];
  const int len = table_len(dims);
  for (int i = threadIdx.x; i < len; i += blockDim.x) smem[i] = tab[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int msg = blockIdx.x * WARPS + warp;
  if (msg >= d) return;
  const Plan P = make_plan(smem, dims);
  uint32_t* scr = reinterpret_cast<uint32_t*>(smem + len) + warp * SCRATCH;
  const bool live = lane < P.L;
  const uint64_t q = live ? P.q[lane] : 0, dl = live ? P.dl[lane] : 0;
  const uint64_t dl_sh = live ? P.dl_sh[lane] : 0;
  const uint64_t* z = res + ((size_t)msg * P.L + (live ? lane : 0)) * P.ell;
  // tmp[i] = z[i]*Δ - z[i+1] mod q_j                    decryption.rs:19-27
  auto tmp = [&](int i) -> uint64_t {
    return live ? submod(shoup(z[i], dl, dl_sh, q), z[i + 1], q) : 0;
  };

  // the Horner fold                                     decryption.rs:30-33
  uint64_t last = tmp(0);
  for (int i = 1; i < P.ell - 1; ++i)
    last = live ? addmod(shoup(last, dl, dl_sh, q), tmp(i), q) : 0;

  // centred remainder mod Δ^(l-1)                       decryption.rs:36-38
  Num<NB> a = lift<NB>(last, P, lane);
  const bool a_neg = center(a, P, lane);
  Num<NB> red;
  divmod(a, P.mod, scr, lane, static_cast<Num<NB>*>(nullptr), &red);
  const bool flip = num_gt(red, num_load<NB>(P.half_m, P.mod.nd, lane));
  if (flip) red = num_sub(num_load<NB>(P.mod.d, P.mod.nd, lane), red, lane);
  const bool red_neg = (flip ? !a_neg : a_neg) && !num_zero(red);
  uint64_t noise = to_rns(red, red_neg, P.mod.nd, P, lane);

  // backward substitution, i = l-2 .. 0                 decryption.rs:41-47
  const Num<NB> delta = num_load<NB>(P.delta, P.div.fw, lane);
  Num<NB> quot;
  bool quot_neg = false;
  for (int i = P.ell - 2; i >= 0; --i) {
    Num<NB> an = lift<NB>(live ? submod(noise, tmp(i), q) : 0, P, lane);
    const bool an_neg = center(an, P, lane);
    // (2|a| + Δ) / (2Δ), truncated; the sign follows a
    divmod(num_add(num_add(an, an, lane), delta, lane), P.div, scr, lane, &quot,
           static_cast<Num<NB>*>(nullptr));
    quot_neg = an_neg && !num_zero(quot);
    if (i) noise = to_rns(quot, quot_neg, P.div.nq, P, lane);
  }

  // plaintext = -(z[0] + noise[0]) mod q, centred, clamped
  Num<NB> s = lift<NB>(live ? z[0] : 0, P, lane);
  bool s_neg = center(s, P, lane);
  {
    const bool same = s_neg == quot_neg, ge = num_ge(s, quot);
    const Num<NB> mag = same ? num_add(s, quot, lane)
                             : (ge ? num_sub(s, quot, lane) : num_sub(quot, s, lane));
    s_neg = (same || ge) ? s_neg : quot_neg;
    s_neg = s_neg && !num_zero(mag);
    s = mag;
  }
  const Num<NB> qw = num_load<NB>(P.q_words, P.W, lane);
  const bool s_zero = num_zero(s);
  const Num<NB> val = (s_neg || s_zero) ? s : num_sub(qw, s, lane);
  // mf = centre(val); the result is val's low 64 bits, zeroed for small
  // negatives and for values that overflow u64        decryption.rs:226-247
  const bool neg_mf = num_gt(val, num_load<NB>(P.half_q, P.W, lane));
  const Num<NB> mf = neg_mf ? num_sub(qw, val, lane) : val;
  uint32_t mf_high[NB], val_high[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    mf_high[k] = (k > 0 || lane >= 1) && mf.w[k] != 0;
    val_high[k] = (k > 0 || lane >= 2) && val.w[k] != 0;
  }
  const bool mf_small = ballot_words<NB>(mf_high) == 0;
  const bool overflow = ballot_words<NB>(val_high) != 0;
  const uint32_t mf0 = __shfl_sync(FULL, mf.w[0], 0);
  const uint32_t v0 = __shfl_sync(FULL, val.w[0], 0), v1 = __shfl_sync(FULL, val.w[0], 1);
  const bool small_neg = neg_mf && mf_small && mf0 <= 1000;
  if (lane == 0) out[msg] = (small_neg || overflow) ? 0 : ((uint64_t)v1 << 32 | v0);
}

}  // namespace

// Launches on ``stream`` and returns the first CUDA error (0 on success).
// res int64 [d, L, l] (canonical residues), contiguous; dims int32 [12]: L,
// l, W, the words of q, then (fw, words of R, words of D, quotient words) of
// the divisor Δ^(l-1) and of 2Δ; tab int64, the packed table block of
// pvw_tpu_torch/crypto/device_decode.py::kernel_block, its length
// ``tab_len``; out int64 [d]. L <= 32, 2 <= l <= 32, W <= 64.
extern "C" int pvw_decode(const void* res, int d, const int* dims, const void* tab,
                          int tab_len, void* out, void* stream) {
  const Dims D{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
               dims[6], dims[7], dims[8], dims[9], dims[10], dims[11]};
  const bool sizes_ok = D.L >= 1 && D.L <= MAX_LIMBS && D.ell >= 2 && D.ell <= MAX_ELL &&
                        D.W >= 1 && D.W <= MAX_WORDS && D.nwq >= 1 && D.nwq <= D.W &&
                        D.m_fw <= D.W && D.v_fw <= D.W && D.m_nq <= D.m_fw &&
                        D.v_nq <= D.v_fw && D.m_nr <= D.m_fw && D.v_nr <= D.v_fw &&
                        D.m_nd <= D.W && D.v_nd <= D.W && D.m_nd >= 1 && D.v_nd >= 1 &&
                        D.m_nr >= 1 && D.v_nr >= 1 && D.m_nq >= 1 && D.v_nq >= 1;
  if (d <= 0 || !sizes_ok || tab_len != table_len(D)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tab_len * sizeof(uint64_t) + WARPS * SCRATCH * sizeof(uint32_t);
  const unsigned blocks = (unsigned)((d + WARPS - 1) / WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  const uint64_t* r = (const uint64_t*)res;
  const uint64_t* t = (const uint64_t*)tab;
  uint64_t* o = (uint64_t*)out;
  cudaError_t err;
  if (D.W <= 32) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(decode_kernel<1>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    decode_kernel<1><<<blocks, 32 * WARPS, smem, s>>>(r, d, D, t, o);
  } else {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(decode_kernel<2>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    decode_kernel<2><<<blocks, 32 * WARPS, smem, s>>>(r, d, D, t, o);
  }
  return (int)cudaGetLastError();
}
