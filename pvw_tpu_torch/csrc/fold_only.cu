// The second pass of the two-pass product: int32 digit columns in device
// memory -> canonical residues, for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/probe_twopass.py::fold_only (body
// _fold_only_body): kernel 1's fold epilogue with its digit products read
// from device memory instead of the tensor cores. For the columns
// cols[ch, r, c, j] (int32, any value) it writes
//
//   out[ch, r, j] = sum_{c<nd} 2^(8c) * cols[ch, r, c, j]   mod q   (canonical, int64)
//
// with digit_mma::Fold, the fold kernels 1 and 3 run from their registers
// (bias each column by 2^31, four to a u64 group, a 64-bit Shoup product by
// 2^(32g) mod q, minus the bias). The tables are the port's [CH, 8] rows of
// fused_modmat.pack_tables, not the TPU kernel's 36 u32 words; any exact
// fold gives the same canonical residue.
//
// What bounds it on an H100: bytes. Each output reads its nd columns (4*nd
// bytes) and writes 8: at the config-4 c2 shape (CH = 272, m = n = 1024,
// nd = 8) 9.13 GB in and 2.28 GB out, 3.41 ms at 3.35 TB/s; at the toy c2
// shape (CH = 16, m = n = 4096, nd = 5) 5.37 + 2.15 GB, 2.24 ms. So a
// thread folds one output: a warp's loads of one column are 128 contiguous
// bytes, its stores 256, every load of a thread independent (nd in flight),
// the columns read and the residues written with streaming hints (each byte
// is touched once). The 64-bit Shoup products (__umul64hi) keep it in CUDA.

#include <cstdint>
#include <cuda_runtime.h>

#include "digit_mma.cuh"

namespace {

constexpr int THREADS = 256;            // outputs of a block: 256 of one row

template <int ND>
__global__ void __launch_bounds__(THREADS)
fold_only_kernel(const int32_t* __restrict__ cols, const int64_t* __restrict__ tables,
                 int64_t* __restrict__ out, int m, int n, int blocks_per_row) {
  const long long row = blockIdx.x / blocks_per_row;          // ch * m + r
  const int j = (int)(blockIdx.x % blocks_per_row) * THREADS + (int)threadIdx.x;
  if (j >= n) return;
  const int32_t* src = cols + row * ND * (long long)n + j;
  int32_t p[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) p[c] = __ldcs(src + (long long)c * n);
  const digit_mma::Fold fold(tables + (row / m) * digit_mma::TAB);
  __stcs(reinterpret_cast<long long*>(out) + row * n + j, (long long)fold(p));
}

}  // namespace

// cols int32 [ch, m, nd, n], tables int64 [ch, 8] (q, the bias of nd
// columns, (2^(32g) mod q, its Shoup companion) for g < 2), out int64
// [ch, m, n], all contiguous; nd <= 8. Launches on ``stream``; returns a
// CUDA error code (0 on success).
extern "C" int pvw_fold_only(const void* cols, const void* tables, void* out, int ch, int m,
                             int nd, int n, void* stream) {
  if (ch <= 0 || m <= 0 || n <= 0 || nd < 1 || nd > 8) return (int)cudaErrorInvalidValue;
  const int per_row = (n + THREADS - 1) / THREADS;
  const long long blocks = (long long)ch * m * per_row;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto c = (const int32_t*)cols;
  const auto t = (const int64_t*)tables;
  const auto o = (int64_t*)out;
#define PVW_GO(ND)                                                                 \
  case ND:                                                                         \
    fold_only_kernel<ND><<<(unsigned)blocks, THREADS, 0, s>>>(c, t, o, m, n, per_row); \
    break;
  switch (nd) {
    PVW_GO(1) PVW_GO(2) PVW_GO(3) PVW_GO(4) PVW_GO(5) PVW_GO(6) PVW_GO(7)
    default: PVW_GO(8)
  }
#undef PVW_GO
  return (int)cudaGetLastError();
}
