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
// What bounds it on an H100: the digit products. At the config-4 c2 shape
// (CH = 272, m = n = 1024, kd = 4096, nd = 8) they are 9.35e12 int8 MACs,
// 9.45 ms at the int8 tensor-core peak (1,979 TOPS, 2 ops a MAC); the bytes
// it must move (the int8 inputs, the int64 output of 2.3 GB) take 3.75 ms at
// 3.35 TB/s. So the bound is compute, and the contraction runs on the
// tensor cores: mma.sync m16n8k32 s8 x s8 -> s32.
//
// The design: one block of 16 warps per (channel, 128 x 32 output tile);
// each warp owns a 16 x 16 tile and keeps nd x 2 accumulator fragments (64
// registers at nd = 8). The contraction is staged in steps of 64 bytes: the
// lhs rows as they lie (k contiguous, the A operand's layout), the band
// transposed on the way in (four k rows of 16 columns loaded as 16-byte
// vectors, their bytes transposed with __byte_perm so that each 32-bit word
// holds four k of one column, the B operand's layout). The next step's
// global loads are in flight in registers while the tensor cores work on
// the current one. The shared tiles are padded so that fragment reads hit
// 32 distinct banks. 128-row tiles halve the band's re-reads from L2
// against 64-row ones: at nd = 8 the band is the larger operand. The
// epilogue adds the noise NTT to the int32 columns and folds them with
// native 64-bit Shoup multiplies (the TPU kernel's u32-pair fold exists
// only because the TPU lacks 64-bit integers). The grid walks the n tiles
// fastest and the channel slowest, so the blocks in flight share one
// channel's operands in L2.
// Left for later: wgmma with TMA loads and a multi-stage ring, a band laid
// out k-packed by its producer (no transposing here), and overlap of the
// epilogue with the next tile.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int BM = 128;        // output rows per block: 8 warps of 16
constexpr int BN = 32;         // output columns per block: 2 warps of 16
constexpr int KT = 64;         // contraction bytes staged per step
constexpr int KW = KT / 4;     // packed 32-bit words per staged row
constexpr int SA = KW + 4;     // sA row stride (words): conflict-free A fragments
constexpr int SB = BN + 8;     // sB row stride (words): conflict-free B fragments
constexpr int THREADS = BM / 16 * (BN / 16) * 32;   // a warp per 16 x 16 tile
constexpr int A_TASKS = BM * KT / 16;               // 16-byte lhs chunks a step
constexpr int B_TASKS = KW * (BN / 16);             // 4 x 16-byte band chunks a plane
static_assert(A_TASKS <= THREADS && 8 * B_TASKS <= THREADS, "one staging task a thread");
constexpr int MAX_ROWS = 64;   // noise MAC rows: l * jr <= 32 * 2
constexpr int TAB = 8;         // per-channel fold table width

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

// tables [CH, TAB] int64: q, bias K (sum_c 2^31 * 2^(8c) mod q), then
// (w_g, w_g') for the groups g = 0, 1 of four columns: w_g = 2^(32g) mod q
// and its 64-bit Shoup companion. etab [CH, 3] int64: g, g', (2^64 mod q)*g.
template <int ND>
__global__ void __launch_bounds__(THREADS, 1)
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
  __shared__ __align__(16) uint32_t sA[BM * SA];
  __shared__ __align__(16) uint32_t sB[ND * KW * SB];
  __shared__ int32_t sN[MAX_ROWS * ND];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ch = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                 // mma fragment coordinates
  const int wm = warp % (BM / 16) * 16, wn = warp / (BM / 16) * 16;  // the warp's tile
  const int8_t* A = lhs + (size_t)ch * m * kd;
  const int8_t* B = band + (size_t)ch * ND * kd * n;
  const bool vecA = kd % 16 == 0 && (reinterpret_cast<uintptr_t>(lhs) & 15) == 0;
  const bool vecB = n % 16 == 0 && (reinterpret_cast<uintptr_t>(band) & 15) == 0;

  for (int i = tid; i < nrows * ND; i += THREADS)
    sN[i] = ntab[(size_t)ch * nrows * ND + i];

  // staging tasks: A, 16 k-bytes of one row; B, four k rows x 16 columns
  // of one plane
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
    if (a_task) *reinterpret_cast<uint4*>(&sA[a_row * SA + 4 * a_kq]) = ra;
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

  int32_t acc[ND][2][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0;

  load(0);
  for (int k0 = 0; k0 < kd; k0 += KT) {
    store();
    __syncthreads();
    if (k0 + KT < kd) load(k0 + KT);  // in flight while the tensor cores run
#pragma unroll
    for (int ks = 0; ks < KW; ks += 8) {
      const uint32_t a0 = sA[(wm + g) * SA + ks + t];
      const uint32_t a1 = sA[(wm + g + 8) * SA + ks + t];
      const uint32_t a2 = sA[(wm + g) * SA + ks + 4 + t];
      const uint32_t a3 = sA[(wm + g + 8) * SA + ks + 4 + t];
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t* b = sB + (c * KW + ks + t) * SB + wn + 8 * j + g;
          mma_s8(acc[c][j], a0, a1, a2, a3, b[0], b[4 * SB]);
        }
    }
    __syncthreads();
  }

  const int64_t* T = tables + (size_t)ch * TAB;
  const uint64_t q = (uint64_t)T[0], bias = (uint64_t)T[1];
  const uint64_t w0 = (uint64_t)T[2], wp0 = (uint64_t)T[3];
  const uint64_t w1 = (uint64_t)T[4], wp1 = (uint64_t)T[5];
  uint64_t gg = 0, gs = 0, wrap = 0;
  if (sc != nullptr) {
    gg = (uint64_t)etab[(size_t)ch * 3];
    gs = (uint64_t)etab[(size_t)ch * 3 + 1];
    wrap = (uint64_t)etab[(size_t)ch * 3 + 2];
  }
  const size_t plane = (size_t)m * n;
  // accumulator e of fragment j: row g (+8 for e >= 2), column 2t (+1 for odd e)
  auto row_of = [&](int e) { return m0 + wm + g + 8 * (e >> 1); };
  auto col_of = [&](int j, int e) { return n0 + wn + 8 * j + 2 * t + (e & 1); };
  // noise NTT into the columns: value rows (coefficient r composed from its
  // jr digit planes, against the jr = 1 table) or raw digit rows; the loads
  // of the thread's eight outputs for one row are in flight together
  for (int r = 0; r < nrows; ++r) {
    int32_t v[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_of(e), col = col_of(j, e);
        v[j][e] = 0;
        if (row >= m || col >= n) continue;
        const size_t idx = (size_t)row * n + col;
        if (vals) {
          v[j][e] = noise[(size_t)(r * jr) * plane + idx];
          if (jr == 2) v[j][e] += 256 * (int32_t)noise[(size_t)(r * 2 + 1) * plane + idx];
        } else {
          v[j][e] = noise[(size_t)r * plane + idx];
        }
      }
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int32_t w = sN[r * ND + c];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][j][e] += v[j][e] * w;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_of(e), col = col_of(j, e);
      if (row >= m || col >= n) continue;
      const size_t idx = (size_t)row * n + col;
      int32_t p[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) p[c] = acc[c][j][e];
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
        uint64_t enc;
        if (encode32) {
          enc = shoup(s & 0xFFFFFFFFull, gg, gs, q);
        } else {
          enc = shoup(s, gg, gs, q);
          // Rust `as i64` (encryption.rs:195): m >= 2^63 encodes m - 2^64
          if (s >> 63) enc = submod(enc, wrap, q);
        }
        res = addmod(res, enc, q);
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
  if (ch <= 0 || ch > 65535 || m <= 0 || n <= 0 || kd <= 0 || nd < 1 || nd > 8 ||
      nrows < 0 || nrows > MAX_ROWS || (nrows > 0 && jr != 1 && jr != 2) ||
      (nrows > 0 && noise == nullptr) || (sc == nullptr) != (etab == nullptr) ||
      (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, ch);
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
