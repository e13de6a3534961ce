// Signed-coefficient NTT and scaled-digit band in one pass, for Hopper
// (sm_90a): the r-stage of encryption on deep modulus chains.
//
// Replaces the TPU kernel pvw_tpu/ops/pallas_modmat.py::ntt_prescale_band
// (body _ntt_prescale_body). For small signed coefficient vectors
// r[kk, col, 0..l) (|r| <= max_abs, jr balanced 8-bit digits each) and every
// channel ch = (limb i, NTT slot s) it computes the canonical residue
//
//   v = sum_j r[kk, col, j] * psi_i^(j*(2s+1))  mod q_i
//
// and writes the nd balanced digits of each scale v * 2^(8t) mod q_i:
//
//   out[ch, j, col, kk*nd + t] = digit j of (v * 2^(8t) mod q_i)
//
// the band that the fused matmuls contract, laid out k-packed: storage int8
// [CH, nd, d, kd_pad] with kd = k*nd contiguous and the row pitch kd_pad =
// kd rounded up to 16 bytes, its pad bytes zero (wgmma reads 8-bit operands
// K-major only, and TMA needs 16-byte strides). As the logical band
// [CH, nd, kd, d] it is bit for bit the plain composition
// prescale_digits_band(ntt_forward_signed_ch(r)).
// The steps:
//   (a) the C1 = nd + jr - 1 NTT columns col[c] = sum_r xd[r] * ntab[ch, c, r]
//       over the l*jr signed-digit rows, four rows per __dp4a;
//   (b) their exact fold to v: each column biased by 2^31, four columns per
//       u64 group, one native 64-bit Shoup multiply per group by 2^(32g) mod q,
//       the bias taken off once;
//   (c) the nd - 1 Shoup scales by 2^(8t) mod q;
//   (d) the balanced digits. The digits of x in [-128, 127] with the carry
//       taken on a byte >= 128 (pvw_tpu_torch/ops/u64.py::
//       to_signed_digit_list, final carry dropped) are the balanced base-256
//       representation of x mod 2^(8nd); adding 0x80 to every byte turns it
//       into the plain one, so byte j of (x + 0x8080..80) ^ 0x8080..80 is
//       digit j. Two 64-bit operations give all eight digits.
//   (e) the stores: a thread holds one column's nd scaled values (t), their
//       8 x 8 digit bytes transposed with __byte_perm into one word of nd
//       bytes per digit j; neighbouring threads own neighbouring k rows, so
//       a warp's words are 32*nd contiguous bytes of a row (a block's four
//       warps along k 128*nd), stored a word a lane where nd divides 16, else
//       gathered in shared memory and written as 16-byte chunks; the rows
//       past k give the zero pads. Two stores without the shared memory,
//       by warp shuffles (probes/prescale_shuffle.cu) and with lanes that
//       own 16 k rows (probes/prescale_lane16.cu), measured slower at nd = 5
//       (probes/prescale_variants.py, PERF.md; the three probes are kept
//       to commit bca0803).
//
// What bounds it on an H100: bytes. At the config-4 r shape (17 limbs x
// l = 16 slots, k = 512, d = 1024, nd = 8) the band is 9.13 GB written, 2.73
// ms at 3.35 TB/s; the coefficients are 34 MB. Its operations are 1.8e10
// int8 MACs (0.02 ms at the int8 tensor-core rate) and nine 64-bit Shoup
// products per (channel, k-row, column), counted as 1.5e10 32-bit
// multiply-adds on the CUDA cores (0.46 ms at the SMs' issue rate of 132 x
// 128 lanes x 1.98 GHz). A
// block serves one limb and loops over its l slots, so each coefficient
// vector is read and split into digits once per limb, not once per channel;
// the twiddle digits sit in (dynamic) shared memory, 74 KB at l = 64, jr = 2.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int KX = 32;                  // k rows a warp: its lanes' neighbouring rows
constexpr int WY = 4;                   // warps a block along k, on consecutive k rows
constexpr int QY = 2;                   // column groups a block, a warp each
constexpr int CX = 1;                   // columns a thread (a column group)
constexpr int THREADS = KX * WY * QY;
constexpr int MAX_C1 = 9;               // NTT columns: nd + jr - 1 <= 8 + 2 - 1
constexpr int TAB = 22;                 // per-limb table width
constexpr uint64_t DIGIT_BIAS = 0x8080808080808080ull;

// coeffs int32 [k, d, DEG]; ntab int8 [L*DEG, C1, DEG*JR] (the scaled
// twiddle digits, row j*JR + dd for coefficient j, digit dd); tabs int64
// [L, TAB]: q, the bias K of C1 columns, (2^(32g) mod q, Shoup companion) for
// g < 3, then (2^(8t) mod q, Shoup companion) for t = 1..7; out [L*DEG, nd,
// d, kd_pad], k-packed.
template <int DEG, int JR>
__global__ void __launch_bounds__(THREADS)
ntt_prescale_band_kernel(const int32_t* __restrict__ coeffs,
                         const int8_t* __restrict__ ntab,
                         const int64_t* __restrict__ tabs,
                         int8_t* __restrict__ out, int k, int d, int nd, int kd_pad) {
  constexpr int LW = DEG * JR / 4;      // packed digit words per vector
  extern __shared__ uint64_t smem[];    // sT[TAB], then sN[DEG * C1 * LW]
  uint64_t* sT = smem;
  uint32_t* sN = reinterpret_cast<uint32_t*>(smem + TAB);

  const int limb = blockIdx.z;
  const int C1 = nd + JR - 1;
  const int tid = threadIdx.y * KX + threadIdx.x;
  const uint32_t* nt = reinterpret_cast<const uint32_t*>(ntab) +
                       (size_t)limb * DEG * C1 * LW;
  for (int w = tid; w < DEG * C1 * LW; w += THREADS) sN[w] = nt[w];
  if (tid < TAB) sT[tid] = (uint64_t)tabs[(size_t)limb * TAB + tid];
  __syncthreads();

  // a warp: 32 neighbouring k rows of CX columns from row kk0 (rows past k
  // compute zeros: the pads of the band's rows); a block's WY warps along k
  // write 32 * WY * nd contiguous bytes of each of its band rows
  const int kk0 = (blockIdx.y * WY + threadIdx.y % WY) * KX;
  const int kk = kk0 + threadIdx.x;
  const int col0 = (blockIdx.x * QY + threadIdx.y / WY) * CX;
  if (kk0 * nd >= kd_pad || col0 >= d) return;     // the whole warp

  // signed digits of the CX columns' coefficient vectors, four rows a word
  uint32_t x[CX][LW];
#pragma unroll
  for (int c = 0; c < CX; ++c) {
    int32_t v[DEG];
    if (kk < k && col0 + c < d) {
      const int4* p = reinterpret_cast<const int4*>(coeffs + ((size_t)kk * d + col0 + c) * DEG);
#pragma unroll
      for (int e = 0; e < DEG / 4; ++e) {
        const int4 t = __ldg(p + e);
        v[4 * e] = t.x; v[4 * e + 1] = t.y; v[4 * e + 2] = t.z; v[4 * e + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < DEG; ++e) v[e] = 0;
    }
#pragma unroll
    for (int w = 0; w < LW; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = 4 * w + b, j = r / JR, dd = r % JR;
        int32_t dig = v[j];
        if (JR == 2) {
          const int32_t d0 = ((v[j] + 128) & 255) - 128;
          dig = dd == 0 ? d0 : (v[j] - d0) >> 8;
        }
        word |= (uint32_t)(dig & 0xFF) << (8 * b);
      }
      x[c][w] = word;
    }
  }

  const uint64_t q = sT[0], bias = sT[1];
  const size_t plane = (size_t)d * kd_pad;          // one digit plane j
  // the warp's 32 * nd bytes of a band row from row kk0, at a 32-byte
  // boundary: where nd divides 16, each lane stores its nd bytes (the lanes
  // past the pad store nothing); else they are gathered in shared memory
  // and written as 16-byte chunks up to the row's end
  const bool direct = 16 % nd == 0;
  __shared__ __align__(16) uint8_t seg[WY * QY][8 * KX];
  uint8_t* my = seg[threadIdx.y];
  const int chunks = min(2 * nd, (kd_pad - kk0 * nd) / 16);
#pragma unroll 1
  for (int s = 0; s < DEG; ++s) {
    // (a) NTT columns, (b) grouped fold
    uint64_t G[CX][3];
#pragma unroll
    for (int c = 0; c < CX; ++c) G[c][0] = G[c][1] = G[c][2] = 0;
    const uint32_t* ns = sN + (size_t)s * C1 * LW;
#pragma unroll
    for (int cc = 0; cc < MAX_C1; ++cc) {
      if (cc < C1) {
        uint32_t nw[LW];
#pragma unroll
        for (int w = 0; w < LW; ++w) nw[w] = ns[cc * LW + w];
#pragma unroll
        for (int c = 0; c < CX; ++c) {
          int32_t acc = 0;
#pragma unroll
          for (int w = 0; w < LW; ++w) acc = __dp4a((int)x[c][w], (int)nw[w], acc);
          G[c][cc / 4] += (uint64_t)((uint32_t)acc ^ 0x80000000u) << (8 * (cc % 4));
        }
      }
    }
    int8_t* o = out + (size_t)(limb * DEG + s) * nd * plane + (size_t)kk0 * nd;
#pragma unroll
    for (int c = 0; c < CX; ++c) {
      if (col0 + c >= d) break;
      uint64_t r = shoup(G[c][0], sT[2], sT[3], q);
      if (C1 > 4) r = addmod(r, shoup(G[c][1], sT[4], sT[5], q), q);
      if (C1 > 8) r = addmod(r, shoup(G[c][2], sT[6], sT[7], q), q);
      const uint64_t v = submod(r, bias, q);
      // (c) scales, (d) digits: lo/hi words of the digit bytes of scale t
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        uint64_t z = 0;
        if (t < nd) {
          const uint64_t y = t == 0 ? v : shoup(v, sT[8 + 2 * (t - 1)], sT[9 + 2 * (t - 1)], q);
          z = (y + DIGIT_BIAS) ^ DIGIT_BIAS;
        }
        lo[t] = (uint32_t)z;
        hi[t] = (uint32_t)(z >> 32);
      }
      // (e) word j = digit j of the scales t = 0..nd-1, byte t
      uint32_t wl[8], wh[8];
      transpose_bytes(lo, wl);
      transpose_bytes(lo + 4, wh);
      transpose_bytes(hi, wl + 4);
      transpose_bytes(hi + 4, wh + 4);
      int8_t* row = o + (size_t)(col0 + c) * kd_pad;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nd) break;
        const uint64_t word = (uint64_t)wl[j] | ((uint64_t)wh[j] << 32);
        int8_t* p = row + (size_t)j * plane;
        if (direct) {
          if (kk * nd < kd_pad) {
            int8_t* pw = p + threadIdx.x * nd;
            if (nd == 8) *reinterpret_cast<uint64_t*>(pw) = word;
            else if (nd == 4) *reinterpret_cast<uint32_t*>(pw) = (uint32_t)word;
            else if (nd == 2) *reinterpret_cast<uint16_t*>(pw) = (uint16_t)word;
            else *pw = (int8_t)word;
          }
        } else {
          // byte b of the word from its 32-bit half by a constant shift (a
          // loop of 64-bit shifts by runtime amounts took 15% longer at
          // nd = 5: the probe prescale_variants.py, looped_gather)
          uint8_t* mine = my + threadIdx.x * nd;
#pragma unroll
          for (int b = 0; b < 8; ++b)
            if (b < nd) mine[b] = (uint8_t)((b < 4 ? wl[j] : wh[j]) >> (8 * (b & 3)));
          __syncwarp();
          if ((int)threadIdx.x < chunks)
            reinterpret_cast<uint4*>(p)[threadIdx.x] = reinterpret_cast<const uint4*>(my)[threadIdx.x];
          __syncwarp();
        }
      }
    }
  }
}

template <int DEG, int JR>
cudaError_t launch(dim3 grid, cudaStream_t stream, const int32_t* coeffs,
                   const int8_t* ntab, const int64_t* tabs, int8_t* out, int k, int d,
                   int nd, int kd_pad) {
  const int smem = TAB * sizeof(uint64_t) + DEG * (nd + JR - 1) * (DEG * JR / 4) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      ntt_prescale_band_kernel<DEG, JR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ntt_prescale_band_kernel<DEG, JR><<<grid, dim3(KX, WY * QY), smem, stream>>>(
      coeffs, ntab, tabs, out, k, d, nd, kd_pad);
  return cudaGetLastError();
}

}  // namespace

// Launches on ``stream`` and returns the first CUDA error (0 on success).
// deg is 8, 16, 32 or 64; coeffs int32 [k, d, deg], ntab int8 [L*deg, nd+jr-1, deg*jr], tabs int64
// [L, 22], out int8 [L*deg, nd, d, kd_pad] (kd_pad = k*nd rounded up to 16),
// k-packed, pads written zero; all contiguous, out 16-byte aligned.
extern "C" int pvw_ntt_prescale_band(const void* coeffs, const void* ntab,
                                     const void* tabs, void* out, int L, int deg,
                                     int jr, int k, int d, int nd, int kd_pad, void* stream) {
  if (L <= 0 || L > 65535 || k <= 0 || d <= 0 || nd < 1 || nd > 8 ||
      (jr != 1 && jr != 2) || (deg != 8 && deg != 16 && deg != 32 && deg != 64) ||
      kd_pad != (k * nd + 15) / 16 * 16 || (reinterpret_cast<uintptr_t>(out) & 15) ||
      (k + KX * WY - 1) / (KX * WY) > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((d + CX * QY - 1) / (CX * QY), (k + KX * WY - 1) / (KX * WY), L);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)coeffs;
  const int8_t* n = (const int8_t*)ntab;
  const int64_t* t = (const int64_t*)tabs;
  int8_t* o = (int8_t*)out;
  switch (deg * 4 + jr) {
    case 8 * 4 + 1: return (int)launch<8, 1>(grid, s, c, n, t, o, k, d, nd, kd_pad);
    case 8 * 4 + 2: return (int)launch<8, 2>(grid, s, c, n, t, o, k, d, nd, kd_pad);
    case 16 * 4 + 1: return (int)launch<16, 1>(grid, s, c, n, t, o, k, d, nd, kd_pad);
    case 16 * 4 + 2: return (int)launch<16, 2>(grid, s, c, n, t, o, k, d, nd, kd_pad);
    case 32 * 4 + 1: return (int)launch<32, 1>(grid, s, c, n, t, o, k, d, nd, kd_pad);
    case 32 * 4 + 2: return (int)launch<32, 2>(grid, s, c, n, t, o, k, d, nd, kd_pad);
    case 64 * 4 + 1: return (int)launch<64, 1>(grid, s, c, n, t, o, k, d, nd, kd_pad);
    default: return (int)launch<64, 2>(grid, s, c, n, t, o, k, d, nd, kd_pad);
  }
}
