// A variant of kernel 4 (pvw_tpu_torch/csrc/ntt_prescale_band.cu) for
// probes/prescale_variants.py: the same function and the same k-packed band
// [L*DEG, nd, d, kd_pad], with lanes that own 16 k rows each instead of
// one. A lane's 16 rows of one band row are 16*nd contiguous bytes, nd whole
// 16-byte chunks a digit plane, so it stores them with no gather across
// lanes. The cost: each lane keeps its 16 rows' coefficient digits (16x
// the registers), and it recomputes the nd scales of each row for every
// digit plane (nd times the Shoup products), so that a plane's 16*nd
// bytes are all it holds at once. Lanes: 16 columns x 16 row groups a
// block, a block 256 rows of 16 columns.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int RL = 16;                  // k rows a lane
constexpr int CB = 16;                  // columns a block
constexpr int RG = 16;                  // row groups a block
constexpr int THREADS = CB * RG;
constexpr int TAB = 22;
constexpr uint64_t DIGIT_BIAS = 0x8080808080808080ull;

template <int DEG, int JR, int ND>
__global__ void __launch_bounds__(THREADS)
lane16_kernel(const int32_t* __restrict__ coeffs, const int8_t* __restrict__ ntab,
              const int64_t* __restrict__ tabs, int8_t* __restrict__ out, int k, int d,
              int kd_pad) {
  constexpr int LW = DEG * JR / 4;
  constexpr int C1 = ND + JR - 1;
  extern __shared__ uint64_t smem[];
  uint64_t* sT = smem;
  uint32_t* sN = reinterpret_cast<uint32_t*>(smem + TAB);
  const int limb = blockIdx.z, tid = threadIdx.x;
  const uint32_t* nt = reinterpret_cast<const uint32_t*>(ntab) + (size_t)limb * DEG * C1 * LW;
  for (int w = tid; w < DEG * C1 * LW; w += THREADS) sN[w] = nt[w];
  if (tid < TAB) sT[tid] = (uint64_t)tabs[(size_t)limb * TAB + tid];
  __syncthreads();

  const int col = blockIdx.x * CB + tid % CB;
  const int kk0 = (blockIdx.y * RG + tid / CB) * RL;
  if (col >= d || kk0 * ND >= kd_pad) return;
  uint32_t x[RL][LW];
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    int32_t v[DEG];
    if (kk0 + r < k) {
      const int4* p = reinterpret_cast<const int4*>(coeffs + ((size_t)(kk0 + r) * d + col) * DEG);
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
        const int rr = 4 * w + b, j = rr / JR, dd = rr % JR;
        int32_t dig = v[j];
        if (JR == 2) {
          const int32_t d0 = ((v[j] + 128) & 255) - 128;
          dig = dd == 0 ? d0 : (v[j] - d0) >> 8;
        }
        word |= (uint32_t)(dig & 0xFF) << (8 * b);
      }
      x[r][w] = word;
    }
  }
  const uint64_t q = sT[0], bias = sT[1];
  const size_t plane = (size_t)d * kd_pad;
  const int chunks = min(ND, (kd_pad - kk0 * ND) / 16);
#pragma unroll 1
  for (int s = 0; s < DEG; ++s) {
    const uint32_t* ns = sN + (size_t)s * C1 * LW;
    uint64_t vr[RL];
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      uint64_t G[3] = {0, 0, 0};
#pragma unroll
      for (int cc = 0; cc < C1; ++cc) {
        int32_t acc = 0;
#pragma unroll
        for (int w = 0; w < LW; ++w) acc = __dp4a((int)x[r][w], (int)ns[cc * LW + w], acc);
        G[cc / 4] += (uint64_t)((uint32_t)acc ^ 0x80000000u) << (8 * (cc % 4));
      }
      uint64_t res = shoup(G[0], sT[2], sT[3], q);
      if (C1 > 4) res = addmod(res, shoup(G[1], sT[4], sT[5], q), q);
      if (C1 > 8) res = addmod(res, shoup(G[2], sT[6], sT[7], q), q);
      vr[r] = submod(res, bias, q);
    }
    int8_t* o = out + ((size_t)(limb * DEG + s) * ND) * plane + (size_t)col * kd_pad +
                (size_t)kk0 * ND;
#pragma unroll 1
    for (int j = 0; j < ND; ++j) {
      // byte r*ND + t of the lane's 16*ND bytes: digit j of scale t of row r
      uint32_t buf[4 * ND];
#pragma unroll
      for (int i = 0; i < 4 * ND; ++i) buf[i] = 0;
#pragma unroll
      for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int t = 0; t < ND; ++t) {
          const uint64_t y = t == 0 ? vr[r] : shoup(vr[r], sT[8 + 2 * (t - 1)],
                                                    sT[9 + 2 * (t - 1)], q);
          const uint64_t z = (y + DIGIT_BIAS) ^ DIGIT_BIAS;
          const int pos = r * ND + t;
          buf[pos / 4] |= (uint32_t)((z >> (8 * j)) & 0xFF) << (8 * (pos % 4));
        }
#pragma unroll
      for (int c = 0; c < ND; ++c)
        if (c < chunks)
          reinterpret_cast<uint4*>(o + (size_t)j * plane)[c] =
              make_uint4(buf[4 * c], buf[4 * c + 1], buf[4 * c + 2], buf[4 * c + 3]);
    }
  }
}

template <int DEG, int JR, int ND>
cudaError_t launch(cudaStream_t stream, const int32_t* c, const int8_t* n, const int64_t* t,
                   int8_t* o, int L, int k, int d, int kd_pad) {
  const int smem = TAB * 8 + DEG * (ND + JR - 1) * (DEG * JR / 4) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      lane16_kernel<DEG, JR, ND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((d + CB - 1) / CB, (k + RG * RL - 1) / (RG * RL), L);
  lane16_kernel<DEG, JR, ND><<<grid, THREADS, smem, stream>>>(c, n, t, o, k, d, kd_pad);
  return cudaGetLastError();
}

template <int DEG, int JR>
cudaError_t by_nd(cudaStream_t s, const int32_t* c, const int8_t* n, const int64_t* t,
                  int8_t* o, int L, int k, int d, int nd, int kd_pad) {
  switch (nd) {
    case 5: return launch<DEG, JR, 5>(s, c, n, t, o, L, k, d, kd_pad);
    case 8: return launch<DEG, JR, 8>(s, c, n, t, o, L, k, d, kd_pad);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The committed kernel's entry and contract, for the probe's two r shapes:
// deg 8 or 16, jr 1, nd 5 or 8.
extern "C" int pvw_ntt_prescale_band(const void* coeffs, const void* ntab, const void* tabs,
                                     void* out, int L, int deg, int jr, int k, int d, int nd,
                                     int kd_pad, void* stream) {
  if (jr != 1 || kd_pad != (k * nd + 15) / 16 * 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)coeffs;
  const int8_t* n = (const int8_t*)ntab;
  const int64_t* t = (const int64_t*)tabs;
  int8_t* o = (int8_t*)out;
  switch (deg) {
    case 8: return (int)by_nd<8, 1>(s, c, n, t, o, L, k, d, nd, kd_pad);
    case 16: return (int)by_nd<16, 1>(s, c, n, t, o, L, k, d, nd, kd_pad);
    default: return (int)cudaErrorInvalidValue;
  }
}
