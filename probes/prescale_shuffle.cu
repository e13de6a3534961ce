// A variant of kernel 4 (pvw_tpu_torch/csrc/ntt_prescale_band.cu) for
// probes/prescale_variants.py: the committed source with its store path
// where nd does not divide 16 rewritten. There each lane's nd bytes of a
// digit plane are gathered into 16-byte chunks by warp shuffles and funnel
// shifts (gather_chunk: lane L's chunk [16L, 16L + 16) of the warp's 32*nd
// bytes from the at most 1 + ceil(15/nd) lanes whose words it spans), with
// no shared memory and no warp syncs; the committed kernel stages the
// bytes in shared memory instead. Same entry, same band.

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

// Lane ``lane``'s 16-byte chunk [16 lane, 16 lane + 16) of the warp's
// 32 * ND bytes, where lane s holds bytes [s ND, s ND + ND) (lo: its bytes
// 0-3, hi: 4-7). Every lane takes part in the shuffles, whether or not it
// stores its chunk.
template <int ND>
__device__ __forceinline__ uint4 gather_chunk(uint32_t lo, uint32_t hi, int lane) {
  constexpr int NS = 1 + (14 + ND) / ND;        // source lanes a chunk spans at most
  const int s0 = 16 * lane / ND, off = 16 * lane - s0 * ND;
  // the bytes of lanes s0 .. s0 + NS - 1 in a row from lane s0's byte 0,
  // each lane's word at the constant byte position i * ND
  uint32_t S[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const uint32_t l = __shfl_sync(0xFFFFFFFFu, lo, s0 + i);
    const uint32_t h = ND > 4 ? __shfl_sync(0xFFFFFFFFu, hi, s0 + i) : 0;
    const uint64_t w = (uint64_t)l | (uint64_t)h << 32;
    const int pos = i * ND, sh = 8 * (pos % 4);
    S[pos / 4] |= (uint32_t)(w << sh);
    S[pos / 4 + 1] |= (uint32_t)((w << sh) >> 32);
    if (sh) S[pos / 4 + 2] |= (uint32_t)(w >> (64 - sh));
  }
  // bytes [off, off + 16) of that row: off < ND <= 7 starts in word 0 or 1
  const int sh = 8 * (off % 4);
  uint32_t q[4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
    q[x] = off >= 4 ? __funnelshift_r(S[x + 1], S[x + 2], sh) : __funnelshift_r(S[x], S[x + 1], sh);
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// Digit plane j of a band row, the warp's 32 * ND bytes from ``row`` (lane
// s's word j at bytes [s ND, s ND + ND)), for j < ND: the lanes below
// ``chunks`` store one gathered 16-byte chunk a plane.
template <int ND>
__device__ __forceinline__ void store_chunks(const uint32_t (&wl)[8], const uint32_t (&wh)[8],
                                             int8_t* row, size_t plane, int chunks) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const uint4 chunk = gather_chunk<ND>(wl[j], wh[j], lane);
    if (lane < chunks) reinterpret_cast<uint4*>(row + j * plane)[lane] = chunk;
  }
}

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
  // past the pad store nothing); else the lanes store 16-byte chunks
  // (gather_chunk) up to the row's end
  const bool direct = 16 % nd == 0;
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
      if (direct) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= nd) break;
          const uint64_t word = (uint64_t)wl[j] | ((uint64_t)wh[j] << 32);
          if (kk * nd < kd_pad) {
            int8_t* pw = row + (size_t)j * plane + threadIdx.x * nd;
            if (nd == 8) *reinterpret_cast<uint64_t*>(pw) = word;
            else if (nd == 4) *reinterpret_cast<uint32_t*>(pw) = (uint32_t)word;
            else if (nd == 2) *reinterpret_cast<uint16_t*>(pw) = (uint16_t)word;
            else *pw = (int8_t)word;
          }
        }
      } else {
        switch (nd) {
          case 3: store_chunks<3>(wl, wh, row, plane, chunks); break;
          case 5: store_chunks<5>(wl, wh, row, plane, chunks); break;
          case 6: store_chunks<6>(wl, wh, row, plane, chunks); break;
          default: store_chunks<7>(wl, wh, row, plane, chunks); break;
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
