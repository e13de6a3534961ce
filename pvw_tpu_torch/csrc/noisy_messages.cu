// The decryption contraction for Hopper (sm_90a): <s, c1> - c2 and the inverse
// NTT of a party's messages in one pass over c1.
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA
// (pvw_tpu/crypto/decryption.py:65-78, the digit contraction and the inverse
// NTT). It writes exactly the plain composition
// pvw_tpu_torch/ops/fused_modmat.py::noisy_messages_plain
// (ops/modmat.matmul_channels, then minus c2 and ops/ntt.ntt_inverse):
//
//   acc[i, j, c] = sum_t sk[t, i, j] * c1[i, j, t, c]           mod q_i
//   out[c, i, s] = sum_j inv_i[s, j] * (acc[i, j, c] - c2[i, j, c])  mod q_i
//
// (i limb, j / s NTT slot, t < k, c dealer), PowerBasis residues int64
// [d, L, l], the layout the device decode reads. Without c2 it stops after
// the sums and writes them channel-major [L, l, d]: the partial form a mesh
// shard computes over its k block, whose partials add mod q.
//
// What bounds it on an H100: c1's bytes. At the 256-bit threshold shape (L =
// 17, l = 16, k = 512, d = 921) c1 is 1.026 GB of residues, 0.306 ms at 3.35
// TB/s; the 1.28e8 products are about 0.12 ms at the measured IMAD rate. The
// plain composition splits c1 into eight int8 digits, copies them into the
// GEMM's layout and casts them to 8.2 GB of float64 before the product.
// Here c1 is read once, straight from HBM: a block owns one limb and a tile of
// 32 dealers, a lane a dealer, so a warp's load of a (slot, t) row is 256
// contiguous bytes, streamed past L1 (__ldcs). The key's element of the row
// is one address across the warp (a broadcast from L1; the key is 1 MB and
// stays in L2). Each product is 64 x 64 -> 128 bits, summed exactly into
// three words (k products below 2^124 each); one reduction at the end folds
// them by 2^64 and 2^128 mod q with Shoup products. The block's warps take
// (slot, k range) items; where the grid is short of SMs (the reference's 4
// limbs) k is split further so that 32 warps a block keep loads in flight, and
// the partials add mod q in shared memory. The epilogue has the block's whole
// polynomial for each dealer: minus c2, then the dense l x l inverse NTT by
// Shoup products against the ring's matrix (1/l included), read from a table
// packed once a ring and device, and stores of l contiguous residues a
// dealer.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int TILE = 32;          // dealers a block: a lane a dealer
constexpr int MAX_WARPS = 32;
constexpr int MIN_ITEMS = 16;     // warps a block at least, where k allows
constexpr int UNROLL = 8;         // rows in flight a warp
constexpr int CONSTS = 8;         // words of a limb's table ahead of its matrix
constexpr int MAX_DEGREE = 64;

__device__ __forceinline__ uint64_t load_key(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ uint64_t load_streamed(const uint64_t* p) {
  return __ldcs(reinterpret_cast<const unsigned long long*>(p));
}

// lo + 2^64 hi + 2^128 top += a * b
__device__ __forceinline__ void mac(uint64_t& lo, uint64_t& hi, uint64_t& top, uint64_t a,
                                    uint64_t b) {
  asm("mad.lo.cc.u64 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u64 %1, %3, %4, %1;\n\t"
      "addc.u64 %2, %2, 0;"
      : "+l"(lo), "+l"(hi), "+l"(top)
      : "l"(a), "l"(b));
}

// (lo + 2^64 hi + 2^128 top) mod q; c = the limb's table: q, floor(2^64 / q),
// 2^64 mod q and its Shoup companion, 2^128 mod q and its companion
__device__ __forceinline__ uint64_t reduce3(uint64_t lo, uint64_t hi, uint64_t top,
                                            const uint64_t* c) {
  const uint64_t q = c[0];
  uint64_t r = shoup(lo, 1, c[1], q);
  r = addmod(r, shoup(hi, c[2], c[3], q), q);
  return addmod(r, shoup(top, c[4], c[5], q), q);
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
noisy_messages_kernel(int l, int k, int d, int splits, const uint64_t* __restrict__ sk,
                      long long sk_t, long long sk_i, long long sk_j,
                      const uint64_t* __restrict__ c1, long long c1_i, long long c1_j,
                      long long c1_t, const uint64_t* __restrict__ c2, long long c2_i,
                      long long c2_j, long long c2_c, const uint64_t* __restrict__ tab,
                      uint64_t* __restrict__ out) {
  extern __shared__ uint64_t smem[];
  uint64_t* part = smem;                                  // [l * splits][TILE]
  uint64_t* z = smem + (size_t)l * splits * TILE;         // [l][TILE]
  const int i = blockIdx.y, L = gridDim.y;
  const int c0 = blockIdx.x * TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int col = c0 + lane < d ? c0 + lane : c0;         // a lane past d reads column c0
  const uint64_t* lt = tab + (size_t)i * (CONSTS + 2 * l * l);
  const uint64_t q = lt[0];
  const int items = l * splits, kc = (k + splits - 1) / splits;

  for (int it = warp; it < items; it += warps) {
    const int j = it / splits, s = it - j * splits;
    const int t0 = s * kc, t1 = min(k, t0 + kc);
    const uint64_t* a = sk + i * sk_i + j * sk_j;
    const uint64_t* b = c1 + i * c1_i + j * c1_j + col;
    uint64_t lo = 0, hi = 0, top = 0;
    int t = t0;
    for (; t + UNROLL <= t1; t += UNROLL) {
      uint64_t w[UNROLL], x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        w[u] = load_key(a + (t + u) * sk_t);
        x[u] = load_streamed(b + (t + u) * c1_t);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mac(lo, hi, top, w[u], x[u]);
    }
    for (; t < t1; ++t) mac(lo, hi, top, load_key(a + t * sk_t), load_streamed(b + t * c1_t));
    part[it * TILE + lane] = reduce3(lo, hi, top, lt);
  }
  __syncthreads();

  // the k ranges' partials added mod q; the partial form stores them here
  for (int e = threadIdx.x; e < l * TILE; e += blockDim.x) {
    const int j = e / TILE, ln = e % TILE, c = c0 + ln;
    uint64_t acc = part[j * splits * TILE + ln];
    for (int s = 1; s < splits; ++s) acc = addmod(acc, part[(j * splits + s) * TILE + ln], q);
    if (c2 == nullptr) {
      if (c < d) out[((size_t)i * l + j) * d + c] = acc;
    } else {
      z[e] = c < d ? submod(acc, c2[i * c2_i + j * c2_j + c * c2_c], q) : 0;
    }
  }
  if (c2 == nullptr) return;
  __syncthreads();

  // the inverse NTT: a thread an output coefficient s of dealer c0 + ln
  const uint64_t* inv = lt + CONSTS;                      // (j, s) -> (inv[s, j], Shoup)
  for (int e = threadIdx.x; e < l * TILE; e += blockDim.x) {
    const int ln = e / l, s = e - ln * l, c = c0 + ln;
    uint64_t x = 0;
    for (int j = 0; j < l; ++j) {
      const uint64_t* w = inv + 2 * ((size_t)j * l + s);
      x = addmod(x, shoup(z[j * TILE + ln], w[0], w[1], q), q);
    }
    if (c < d) out[((size_t)c * L + i) * l + s] = x;
  }
}

}  // namespace

// Launches on ``stream`` and returns the first CUDA error (0 on success).
// sk int64 [k, L, l] and c1 int64 [L, l, k, d] by their element strides (c1's
// dealer axis unit-stride), c2 int64 [L, l, d] by its strides or null (the
// partial form); tab int64 [L, 8 + 2 l^2] (fused_modmat.contraction_tables);
// out int64 [d, L, l] contiguous, or [L, l, d] without c2. Every residue
// canonical, every q < 2^62; 1 <= l <= 64.
extern "C" int pvw_noisy_messages(int L, int l, int k, int d, const void* sk, long long sk_t,
                                  long long sk_i, long long sk_j, const void* c1,
                                  long long c1_i, long long c1_j, long long c1_t,
                                  const void* c2, long long c2_i, long long c2_j,
                                  long long c2_c, const void* tab, void* out, void* stream) {
  if (L <= 0 || L > 65535 || l <= 0 || l > MAX_DEGREE || k < 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (d + TILE - 1) / TILE;
  // split k until the block has MIN_ITEMS warps of work, and on a grid short
  // of one block an SM until it has MAX_WARPS
  int splits = 1;
  while (l * splits < MIN_ITEMS && 2 * splits <= k) splits *= 2;
  if ((long long)tiles * L < sms)
    while (l * splits < MAX_WARPS && 2 * splits <= k) splits *= 2;
  const int warps = l * splits < MAX_WARPS ? l * splits : MAX_WARPS;
  const size_t shared = (size_t)(l * splits + l) * TILE * sizeof(uint64_t);
  noisy_messages_kernel<<<dim3(tiles, L), warps * 32, shared, (cudaStream_t)stream>>>(
      l, k, d, splits, (const uint64_t*)sk, sk_t, sk_i, sk_j, (const uint64_t*)c1, c1_i, c1_j,
      c1_t, (const uint64_t*)c2, c2_i, c2_j, c2_c, (const uint64_t*)tab, (uint64_t*)out);
  return (int)cudaGetLastError();
}
