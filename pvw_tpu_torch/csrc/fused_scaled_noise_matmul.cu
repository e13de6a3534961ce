// Fused scaled-digit modular matmul with the noise NTT and the gadget
// encode in its epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel pvw_tpu/ops/pallas_modmat.py::
// _fused_scaled_noise_matmul (body _make_fold_body). Per channel ch of L*l
// (limb i, NTT slot s) it computes, canonical in [0, q_i):
//
//   out[ch, m, n] = ( sum_{c<nd} 2^(8c) * ( lhs[ch, m, :] . band[ch, c, :, n]
//                                           + sum_r noise_r[m, n] * ntab[ch, r, c] )
//                     + encode(sc[m, n]) * g[ch] ) mod q
//
// lhs int8 [CH, m, kd] and band int8 [CH, nd, kd, n] are balanced digit
// planes (kd = k*nd); the band carries the 2^(8i) scales, so the digit
// contraction gives only nd int32 columns. The noise rows add the NTT of
// the error straight into those columns (ntab = digits of the scaled
// twiddles). Every output is the canonical residue, so any exact arithmetic
// gives the same bytes as the TPU kernel.
//
// What bounds it on an H100: the digit products. At the c2 shape of the
// n = 4096 main path (CH = 16, m = n = 4096, kd = 1280, nd = 5) they are
// 1.72e12 int8 MACs, 1.74 ms at the int8 tensor-core peak (1,979 TOPS,
// 2 ops a MAC); the bytes it must move (int8 inputs, the int64 output of
// 2.1 GB) take 0.87 ms at 3.35 TB/s. So the bound is compute.
//
// This first design is simple and exact, not fast: one block per
// (channel, 64x64 output tile), the int8 tiles staged in shared memory with
// 4 k-values packed per word, __dp4a into nd int32 accumulators per
// output, and the fold done with native 64-bit Shoup multiplies (the TPU
// kernel's u32-pair fold exists only because the TPU lacks 64-bit
// integers). dp4a runs on the CUDA cores, far below the tensor-core rate.
// Left for later: int8 tensor cores (mma.sync / wgmma s8), TMA loads with
// a multi-stage pipeline, and overlap of the epilogue with the next tile's
// loads; the noise planes are re-read by each channel's block (from L2,
// since the channel is the fastest grid index).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;         // output rows per block
constexpr int TN = 64;         // output columns per block
constexpr int KT = 32;         // contraction bytes staged per step
constexpr int KW = KT / 4;     // packed 32-bit words per staged row
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_ROWS = 64;   // noise MAC rows: l * jr <= 32 * 2
constexpr int TAB = 8;         // per-channel fold table width

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

// tables [CH, TAB] int64: q, bias K (sum_c 2^31 * 2^(8c) mod q), then
// (w_g, w_g') for the groups g = 0, 1 of four columns: w_g = 2^(32g) mod q
// and its 64-bit Shoup companion. etab [CH, 3] int64: g, g', (2^64 mod q)*g.
template <int ND>
__global__ void __launch_bounds__(THREADS)
fused_scaled_noise_matmul_kernel(const int8_t* __restrict__ lhs,
                                 const int8_t* __restrict__ band,
                                 const int64_t* __restrict__ tables,
                                 const int32_t* __restrict__ ntab,
                                 const int8_t* __restrict__ noise,
                                 const int64_t* __restrict__ sc,
                                 const int64_t* __restrict__ etab,
                                 int64_t* __restrict__ out,
                                 int m, int n, int kd, int nrows, int jr,
                                 int vals, int encode32) {
  __shared__ int32_t sA[TM][KW + 1];
  __shared__ int32_t sB[ND][KW][TN];
  __shared__ int32_t sN[MAX_ROWS * ND];

  const int ch = blockIdx.x;
  const int n0 = blockIdx.y * TN;
  const int m0 = blockIdx.z * TM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int8_t* A = lhs + (size_t)ch * m * kd;
  const int8_t* B = band + (size_t)ch * ND * kd * n;

  for (int i = tid; i < nrows * ND; i += THREADS)
    sN[i] = ntab[(size_t)ch * nrows * ND + i];

  int32_t acc[ND][4][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][i][j] = 0;

  for (int k0 = 0; k0 < kd; k0 += KT) {
    // lhs tile: 4 consecutive k bytes of a row per word
    for (int w = tid; w < TM * KW; w += THREADS) {
      const int r = w / KW, kw = w % KW, row = m0 + r;
      uint32_t word = 0;
      if (row < m) {
        const int8_t* p = A + (size_t)row * kd;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = k0 + kw * 4 + b;
          if (k < kd) word |= (uint32_t)(uint8_t)p[k] << (8 * b);
        }
      }
      sA[r][kw] = (int32_t)word;
    }
    // band tile, transposed so 4 consecutive k bytes share a word
    for (int w = tid; w < ND * KW * TN; w += THREADS) {
      const int nn = w % TN, rest = w / TN;
      const int kw = rest % KW, c = rest / KW, col = n0 + nn;
      uint32_t word = 0;
      if (col < n) {
        const int8_t* p = B + (size_t)c * kd * n + col;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = k0 + kw * 4 + b;
          if (k < kd) word |= (uint32_t)(uint8_t)p[(size_t)k * n] << (8 * b);
        }
      }
      sB[c][kw][nn] = (int32_t)word;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[ty + 16 * i][kw];
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int32_t b = sB[c][kw][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][i][j] = __dp4a(a[i], b, acc[c][i][j]);
        }
    }
    __syncthreads();
  }

  const int64_t* T = tables + (size_t)ch * TAB;
  const uint64_t q = (uint64_t)T[0], bias = (uint64_t)T[1];
  const uint64_t w0 = (uint64_t)T[2], wp0 = (uint64_t)T[3];
  const uint64_t w1 = (uint64_t)T[4], wp1 = (uint64_t)T[5];
  uint64_t g = 0, gs = 0, wrap = 0;
  if (sc != nullptr) {
    g = (uint64_t)etab[(size_t)ch * 3];
    gs = (uint64_t)etab[(size_t)ch * 3 + 1];
    wrap = (uint64_t)etab[(size_t)ch * 3 + 2];
  }
  const size_t plane = (size_t)m * n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row >= m || col >= n) continue;
      const size_t idx = (size_t)row * n + col;
      int32_t p[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) p[c] = acc[c][i][j];
      // noise NTT: value rows (coefficient r composed from its jr digit
      // planes, against the jr = 1 table) or raw digit rows
      for (int r = 0; r < nrows; ++r) {
        int32_t v;
        if (vals) {
          v = noise[(size_t)(r * jr) * plane + idx];
          if (jr == 2) v += 256 * (int32_t)noise[(size_t)(r * 2 + 1) * plane + idx];
        } else {
          v = noise[(size_t)r * plane + idx];
        }
#pragma unroll
        for (int c = 0; c < ND; ++c) p[c] += v * sN[r * ND + c];
      }
      // exact fold: bias each column by 2^31, group four columns per u64
      uint64_t G0 = 0, G1 = 0;
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const uint64_t u = (uint64_t)((uint32_t)p[c] ^ 0x80000000u);
        if (c < 4) G0 += u << (8 * c);
        else G1 += u << (8 * (c - 4));
      }
      uint64_t res = shoup(G0, w0, wp0, q);
      if (ND > 4) res = addmod(res, shoup(G1, w1, wp1, q), q);
      res = submod(res, bias, q);
      if (sc != nullptr) {
        const uint64_t s = (uint64_t)sc[idx];
        uint64_t e;
        if (encode32) {
          e = shoup(s & 0xFFFFFFFFull, g, gs, q);
        } else {
          e = shoup(s, g, gs, q);
          // Rust `as i64` (encryption.rs:195): m >= 2^63 encodes m - 2^64
          if (s >> 63) e = submod(e, wrap, q);
        }
        res = addmod(res, e, q);
      }
      out[(size_t)ch * plane + idx] = (int64_t)res;
    }
}

template <int ND>
void launch(dim3 grid, cudaStream_t stream, const int8_t* lhs, const int8_t* band,
            const int64_t* tables, const int32_t* ntab, const int8_t* noise,
            const int64_t* sc, const int64_t* etab, int64_t* out, int m, int n,
            int kd, int nrows, int jr, int vals, int encode32) {
  fused_scaled_noise_matmul_kernel<ND><<<grid, THREADS, 0, stream>>>(
      lhs, band, tables, ntab, noise, sc, etab, out, m, n, kd, nrows, jr, vals,
      encode32);
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
// ``noise`` may be null (nrows = 0); ``sc`` and ``etab`` are null without
// the encode. All arrays are contiguous.
extern "C" int pvw_fused_scaled_noise_matmul(
    const void* lhs, const void* band, const void* tables, const void* ntab,
    const void* noise, const void* sc, const void* etab, void* out, int ch,
    int m, int n, int kd, int nd, int nrows, int jr, int vals, int encode32,
    void* stream) {
  if (ch <= 0 || m <= 0 || n <= 0 || kd <= 0 || nd < 1 || nd > 8 ||
      nrows < 0 || nrows > MAX_ROWS || (nrows > 0 && jr != 1 && jr != 2) ||
      (nrows > 0 && noise == nullptr) || (sc == nullptr) != (etab == nullptr) ||
      (n + TN - 1) / TN > 65535 || (m + TM - 1) / TM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ch, (n + TN - 1) / TN, (m + TM - 1) / TM);
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* l8 = (const int8_t*)lhs;
  const int8_t* b8 = (const int8_t*)band;
  const int64_t* t = (const int64_t*)tables;
  const int32_t* nt = (const int32_t*)ntab;
  const int8_t* nz = (const int8_t*)noise;
  const int64_t* s64 = (const int64_t*)sc;
  const int64_t* et = (const int64_t*)etab;
  int64_t* o = (int64_t*)out;
  switch (nd) {
    case 1: launch<1>(grid, s, l8, b8, t, nt, nz, s64, et, o, m, n, kd, nrows, jr, vals, encode32); break;
    case 2: launch<2>(grid, s, l8, b8, t, nt, nz, s64, et, o, m, n, kd, nrows, jr, vals, encode32); break;
    case 3: launch<3>(grid, s, l8, b8, t, nt, nz, s64, et, o, m, n, kd, nrows, jr, vals, encode32); break;
    case 4: launch<4>(grid, s, l8, b8, t, nt, nz, s64, et, o, m, n, kd, nrows, jr, vals, encode32); break;
    case 5: launch<5>(grid, s, l8, b8, t, nt, nz, s64, et, o, m, n, kd, nrows, jr, vals, encode32); break;
    case 6: launch<6>(grid, s, l8, b8, t, nt, nz, s64, et, o, m, n, kd, nrows, jr, vals, encode32); break;
    case 7: launch<7>(grid, s, l8, b8, t, nt, nz, s64, et, o, m, n, kd, nrows, jr, vals, encode32); break;
    default: launch<8>(grid, s, l8, b8, t, nt, nz, s64, et, o, m, n, kd, nrows, jr, vals, encode32); break;
  }
  return (int)cudaGetLastError();
}
