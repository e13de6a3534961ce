// The int8 digit contraction of kernels 1 and 3 on Hopper's warpgroup
// tensor cores (sm_90a), fed by a TMA ring in shared memory.
//
// Both kernels contract, per channel, an A operand of rows (the lhs digit
// planes, or the swapped form's rhs digits) against the nd planes of a B
// operand (the scaled band, or the swapped form's scaled lhs planes), both
// int8 and k-contiguous in device memory:
//
//   A [CH, rows, kd]           row pitch and channel stride multiples of 16 bytes
//   B [CH, nd, cols, kd]       the same, plus the plane stride
//
// The band is written k-packed by kernel 4 (csrc/ntt_prescale_band.cu) for
// this: wgmma reads 8-bit operands K-major only, and TMA needs 16-byte
// strides. A tile is 64 rows of A by 32 columns of every B plane. Each
// 128-byte k step (one stage of the ring) is two TMA boxes with the 128-byte
// swizzle, A [64 x 128] and B [nd x 32 x 128] (the nd planes stacked along
// N), and four wgmma m64n(32*nd)k32 s8 x s8 -> s32, one per 32 k bytes. So
// column c*32 + j of the accumulator is plane c of output column j, and a
// thread holds the same (row, column) of every plane in its own registers:
// the fold runs there, with no shuffle. TMA zero-fills past kd, rows, cols,
// so no tail code touches the contraction.
//
// Kernel 2 (csrc/banded_matmul.cu) uses the primitives below (mbarriers,
// TMA loads, Wgmma<16(2nd-1)> into all its columns) with a stage
// layout and roles of its own.
//
// Roles (one big if/else a kernel, as setmaxnreg needs): warpgroup 0 is the
// producer (one thread starts the TMA copies: it waits on a stage's
// ``empty`` barrier and arms its ``full`` barrier with the stage's bytes),
// warpgroups 1 and 2 are consumers in ping-pong: the ring is filled tile
// after tile, tile j of a block going to consumer j % 2, and the consumers
// take turns on their contractions (``contract``), so one runs the epilogue
// of its tile from its registers while the other contracts the next.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "digit_mma.cuh"

namespace wgmma_digit {

constexpr int KT = 128;                 // k bytes a stage: one 128-byte swizzled row
constexpr int BM = 64;                  // rows of A a tile: one wgmma m64
constexpr int BN = 32;                  // columns of each B plane a tile
constexpr int A_BYTES = BM * KT;        // 8 KB
constexpr int PLANE_BYTES = BN * KT;    // 4 KB
constexpr int THREADS = 384;            // producer + two consumer warpgroups
constexpr int MAX_STAGES = 8;
constexpr int MAX_SMEM = 232448;        // a block's shared memory on an H100
constexpr int SMEM_SLACK = 1024 + 2 * MAX_STAGES * 8;   // ring alignment, barriers
constexpr int BAR_TURN = 2;             // named barriers 2, 3: consumer 0's, 1's turn

template <int ND>
constexpr int stage_bytes() { return A_BYTES + ND * PLANE_BYTES; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Spins until the phase of parity ``parity`` has completed. A wait of more
// than 2^34 SM clocks (about 9 s; a stage that never arrives) traps, so a
// fault surfaces as a failed launch and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator across the wgmma
// wait that makes it valid
template <int R>
__device__ __forceinline__ void fence_regs(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// shared-memory matrix descriptor of a K-major tile of 128-byte rows with
// the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B): start address,
// stride 1024 bytes between groups of 8 rows, layout type 1; the tile
// starts on a 1024-byte boundary, and +2 advances it by 32 k bytes
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma.mma_async m64nNk32 s32.s8.s8, A and B from shared memory, into the
// N/2 registers of ``d`` from register OFF on (a slice of a larger
// accumulator; products in flight into overlapping slices are not ordered,
// only those of one shape into the same registers are); ``acc`` 0
// overwrites them, else adds to them. One asm body,
// instantiated for each N by PVW_WGMMA(N, G, A, B, F): the accumulator
// operands come in G = N/16 groups of 8 (PVW_WG_G names the operands of a
// group, PVW_WG_D<G> the first G, PVW_WG_O<G> binds them), followed by the
// two descriptors and the flag (operands A, B, F = N/2, +1, +2).
template <int N>
struct Wgmma;

#define PVW_WG_G0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define PVW_WG_G1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define PVW_WG_G2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define PVW_WG_G3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define PVW_WG_G4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define PVW_WG_G5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define PVW_WG_G6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define PVW_WG_G7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define PVW_WG_G8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define PVW_WG_G9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define PVW_WG_G10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define PVW_WG_G11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define PVW_WG_G12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define PVW_WG_G13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define PVW_WG_G14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define PVW_WG_G15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define PVW_WG_D1 PVW_WG_G0
#define PVW_WG_D2 PVW_WG_D1 ", " PVW_WG_G1
#define PVW_WG_D3 PVW_WG_D2 ", " PVW_WG_G2
#define PVW_WG_D4 PVW_WG_D3 ", " PVW_WG_G3
#define PVW_WG_D5 PVW_WG_D4 ", " PVW_WG_G4
#define PVW_WG_D6 PVW_WG_D5 ", " PVW_WG_G5
#define PVW_WG_D7 PVW_WG_D6 ", " PVW_WG_G6
#define PVW_WG_D8 PVW_WG_D7 ", " PVW_WG_G7
#define PVW_WG_D9 PVW_WG_D8 ", " PVW_WG_G8
#define PVW_WG_D10 PVW_WG_D9 ", " PVW_WG_G9
#define PVW_WG_D11 PVW_WG_D10 ", " PVW_WG_G10
#define PVW_WG_D12 PVW_WG_D11 ", " PVW_WG_G11
#define PVW_WG_D13 PVW_WG_D12 ", " PVW_WG_G12
#define PVW_WG_D14 PVW_WG_D13 ", " PVW_WG_G13
#define PVW_WG_D15 PVW_WG_D14 ", " PVW_WG_G14
#define PVW_WG_D16 PVW_WG_D15 ", " PVW_WG_G15
#define PVW_WG_O(g)                                                                      \
  "+r"(d[OFF + 8 * g + 0]), "+r"(d[OFF + 8 * g + 1]), "+r"(d[OFF + 8 * g + 2]),          \
      "+r"(d[OFF + 8 * g + 3]), "+r"(d[OFF + 8 * g + 4]), "+r"(d[OFF + 8 * g + 5]),      \
      "+r"(d[OFF + 8 * g + 6]), "+r"(d[OFF + 8 * g + 7])
#define PVW_WG_O1 PVW_WG_O(0)
#define PVW_WG_O2 PVW_WG_O1, PVW_WG_O(1)
#define PVW_WG_O3 PVW_WG_O2, PVW_WG_O(2)
#define PVW_WG_O4 PVW_WG_O3, PVW_WG_O(3)
#define PVW_WG_O5 PVW_WG_O4, PVW_WG_O(4)
#define PVW_WG_O6 PVW_WG_O5, PVW_WG_O(5)
#define PVW_WG_O7 PVW_WG_O6, PVW_WG_O(6)
#define PVW_WG_O8 PVW_WG_O7, PVW_WG_O(7)
#define PVW_WG_O9 PVW_WG_O8, PVW_WG_O(8)
#define PVW_WG_O10 PVW_WG_O9, PVW_WG_O(9)
#define PVW_WG_O11 PVW_WG_O10, PVW_WG_O(10)
#define PVW_WG_O12 PVW_WG_O11, PVW_WG_O(11)
#define PVW_WG_O13 PVW_WG_O12, PVW_WG_O(12)
#define PVW_WG_O14 PVW_WG_O13, PVW_WG_O(13)
#define PVW_WG_O15 PVW_WG_O14, PVW_WG_O(14)
#define PVW_WG_O16 PVW_WG_O15, PVW_WG_O(15)
#define PVW_WGMMA(N, G, A, B, F)                                                      \
  template <>                                                                      \
  struct Wgmma<N> {                                                                \
    template <int OFF, int R>                                                      \
    __device__ __forceinline__ static void mma(int32_t (&d)[R], uint64_t a,        \
                                               uint64_t b, int acc) {              \
      static_assert(OFF >= 0 && OFF + N / 2 <= R, "accumulator slice out of range"); \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #F ", 0;\n"                \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {"        \
                   PVW_WG_D##G "}, %" #A ", %" #B ", p;\n}\n"                       \
                   : PVW_WG_O##G                                                   \
                   : "l"(a), "l"(b), "r"(acc));                                    \
    }                                                                              \
  };

PVW_WGMMA(16, 1, 8, 9, 10)
PVW_WGMMA(32, 2, 16, 17, 18)
PVW_WGMMA(48, 3, 24, 25, 26)
PVW_WGMMA(64, 4, 32, 33, 34)
PVW_WGMMA(80, 5, 40, 41, 42)
PVW_WGMMA(96, 6, 48, 49, 50)
PVW_WGMMA(112, 7, 56, 57, 58)
PVW_WGMMA(128, 8, 64, 65, 66)
PVW_WGMMA(144, 9, 72, 73, 74)
PVW_WGMMA(160, 10, 80, 81, 82)
PVW_WGMMA(176, 11, 88, 89, 90)
PVW_WGMMA(192, 12, 96, 97, 98)
PVW_WGMMA(208, 13, 104, 105, 106)
PVW_WGMMA(224, 14, 112, 113, 114)
PVW_WGMMA(240, 15, 120, 121, 122)
PVW_WGMMA(256, 16, 128, 129, 130)

#undef PVW_WGMMA
#undef PVW_WG_O
#undef PVW_WG_G0
#undef PVW_WG_G1
#undef PVW_WG_G2
#undef PVW_WG_G3
#undef PVW_WG_G4
#undef PVW_WG_G5
#undef PVW_WG_G6
#undef PVW_WG_G7
#undef PVW_WG_G8
#undef PVW_WG_G9
#undef PVW_WG_G10
#undef PVW_WG_G11
#undef PVW_WG_G12
#undef PVW_WG_G13
#undef PVW_WG_G14
#undef PVW_WG_G15
#undef PVW_WG_D1
#undef PVW_WG_D2
#undef PVW_WG_D3
#undef PVW_WG_D4
#undef PVW_WG_D5
#undef PVW_WG_D6
#undef PVW_WG_D7
#undef PVW_WG_D8
#undef PVW_WG_D9
#undef PVW_WG_D10
#undef PVW_WG_D11
#undef PVW_WG_D12
#undef PVW_WG_D13
#undef PVW_WG_D14
#undef PVW_WG_D15
#undef PVW_WG_D16
#undef PVW_WG_O1
#undef PVW_WG_O2
#undef PVW_WG_O3
#undef PVW_WG_O4
#undef PVW_WG_O5
#undef PVW_WG_O6
#undef PVW_WG_O7
#undef PVW_WG_O8
#undef PVW_WG_O9
#undef PVW_WG_O10
#undef PVW_WG_O11
#undef PVW_WG_O12
#undef PVW_WG_O13
#undef PVW_WG_O14
#undef PVW_WG_O15
#undef PVW_WG_O16

// The ring: S stages of [A | B] from a 1024-byte boundary, then the
// ``extra`` bytes a kernel keeps beside it, then the full and empty
// barriers.
template <int ND>
struct Ring {
  static constexpr int STAGE = stage_bytes<ND>();
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int S;

  __device__ __forceinline__ Ring(uint8_t* smem, int stages, int extra) : S(stages) {
    base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem) + 1023) &
                                      ~(uintptr_t)1023);
    full = reinterpret_cast<uint64_t*>(base + (size_t)stages * STAGE + extra);
    empty = full + stages;
  }
  __device__ __forceinline__ uint8_t* extra() const { return base + (size_t)S * STAGE; }
  __device__ __forceinline__ uint8_t* a(int s) const { return base + (size_t)s * STAGE; }
  __device__ __forceinline__ uint8_t* b(int s) const { return a(s) + A_BYTES; }

  // one thread: ``full`` waits for the TMA bytes, ``empty`` for the four
  // warps of the consumer that read the stage
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
};

// Producer: for tiles j < count of this block (``tile(j, ch, a0, b0)``) its
// nk stages, the ring's slot (j*nk + kb) % S, in order.
template <int ND, class Tiles>
__device__ __forceinline__ void produce(const Ring<ND>& R, const CUtensorMap* ma,
                                        const CUtensorMap* mb, const Tiles& tiles, int count,
                                        int nk) {
  for (int j = 0; j < count; ++j) {
    int ch, a0, b0;
    tiles(j, ch, a0, b0);
    for (int kb = 0; kb < nk; ++kb) {
      const int it = j * nk + kb, s = it % R.S;
      mbar_wait(&R.empty[s], ((it / R.S) & 1) ^ 1);
      mbar_expect_tx(&R.full[s], Ring<ND>::STAGE);
      tma_load_3d(R.a(s), ma, &R.full[s], kb * KT, a0, ch);
      tma_load_4d(R.b(s), mb, &R.full[s], kb * KT, b0, 0, ch);
    }
  }
}

// Consumer ``wg`` (0 or 1): the contraction of tile j into ``acc``
// (overwritten), each stage released as soon as the wgmma reading it has
// completed. The two consumers take turns (named barriers BAR_TURN + wg):
// tile j waits until consumer 1 - wg has waited for every stage of tile
// j - 1 (``wait_turn``, j > 0), then hands on the turn once its own stages
// have arrived (``pass_turn``, a tile j + 1 exists). So a consumer only
// waits on a slot whose previous round has completed, and the phase parity
// of the slot's barrier names the round it waits for.
template <int ND>
__device__ __forceinline__ void contract(int32_t (&acc)[16 * ND], const Ring<ND>& R, int j,
                                         int nk, int wg, bool wait_turn, bool pass_turn,
                                         bool lane0) {
  if (wait_turn) asm volatile("bar.sync %0, 256;" ::"r"(BAR_TURN + wg) : "memory");
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb) {
    const int it = j * nk + kb, s = it % R.S;
    mbar_wait(&R.full[s], (it / R.S) & 1);
    const uint64_t da = sw128_desc(R.a(s)), db = sw128_desc(R.b(s));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 32; ++kk)
      Wgmma<32 * ND>::template mma<0>(acc, da + 2 * kk, db + 2 * kk, kb | kk);
    wgmma_commit();
    wgmma_wait<1>();                    // the previous stage's products are done
    if (prev >= 0 && lane0) mbar_arrive(&R.empty[prev]);
    prev = s;
  }
  if (pass_turn) asm volatile("bar.arrive %0, 256;" ::"r"(BAR_TURN + 1 - wg) : "memory");
  wgmma_wait<0>();
  if (lane0) mbar_arrive(&R.empty[prev]);
  fence_regs(acc);
}

// The masked form's global row range: output row r is global row
// row_off + r (int32, as the TPU kernel's iota); ``on`` 0 keeps every row.
struct Mask {
  int on, row_off, lo, hi;
  __device__ __forceinline__ bool keeps(int row) const {
    const int g = (int)((unsigned)row_off + (unsigned)row);
    return !on || (g >= lo && g < hi);
  }
};

// What the epilogue reads and writes: out int64 [CH, m, n] and, per output
// (row, col), the noise digit planes at p + pl * plane + row * ld + col
// (rows and columns from the tile's output origin), the fold tables [CH, 8],
// the noise table ntab [CH, nrows, nd], the scalars sc [m, n] and etab
// [CH, 3] (null without the encode), post [CH, m, n] (or null).
struct Epilogue {
  const int64_t* tables;
  const int32_t* ntab;
  const int64_t* sc;
  const int64_t* etab;
  const int64_t* post;
  int64_t* out;
  int m, n, nrows, jr, vals, encode32;
  Mask mask;
};

// A consumer's own shared memory for its epilogue: the noise table of the
// tile's channel, the tile's scalars and, where the noise lies in device
// memory, a chunk of STAGE_PLANES of the tile's noise digit planes.
constexpr int MAX_ROWS = 64;            // noise MAC rows: l * jr <= 32 * 2
constexpr int STAGE_PLANES = 8;
constexpr int TILE = BM * BN;           // outputs of a tile: 64 x 32 (32 x 64 swapped)
constexpr int TABLE_BYTES = MAX_ROWS * 8 * 4;
constexpr int SC_BYTES = TILE * 8;

constexpr int scratch_bytes(bool resident) {
  return TABLE_BYTES + SC_BYTES + (resident ? 0 : STAGE_PLANES * TILE);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 16 bytes, of which the first ``bytes`` (0..16) are read and the rest zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
constexpr int BAR_EPI = 4;              // named barriers 4, 5: consumer 0's, 1's own
constexpr int FOLD_GROUP = 8;           // outputs folded, loaded for and stored together

__device__ __forceinline__ void wg_sync(int bar) {
  asm volatile("bar.sync %0, 128;" ::"r"(bar) : "memory");
}

// Where output x of a thread lies in its tile: x = 8h + 2i + e holds A row
// 16w + g + 8h and B column 8i + 2t + e, so its offset in a tile plane of
// ``ld`` output columns is a base of the thread plus a constant of x.
template <bool SW>
__device__ __forceinline__ constexpr int tile_const(int x, int ld) {
  return SW ? (8 * (x >> 1 & 3) + (x & 1)) * ld + 8 * (x >> 3)
            : 8 * (x >> 3) * ld + 8 * (x >> 1 & 3) + (x & 1);
}

// The noise MAC of one tile: for each noise row r, the thread's 16 outputs'
// values (coefficient r composed from its two digit planes 2r, 2r + 1 when
// ``TWO``: value rows at jr = 2; else plane r: value rows at jr = 1, or
// digit rows) times the row's nd table entries sN[r], into the accumulator
// columns; output x's value at ``base`` + tile_const(x) of a tile plane
// (zero outside the output). The planes are ``RESIDENT`` in shared memory
// [R][TILE] (kernel 3's), or lie in device memory at ``src`` [R, m, n] and
// are staged into ``stage`` STAGE_PLANES at a time, 16 bytes a thread from
// the tile's origin (row0, col0) (zero outside), the chunk's loads in flight
// together; the first chunk is there already when ``first_staged``.
template <int ND, bool SW, bool TWO, bool RESIDENT>
__device__ __forceinline__ void noise_mac(int32_t (&acc)[16 * ND], const int32_t* sN,
                                          int nrows, const int8_t* src, int8_t* stage, int m,
                                          int n, int row0, int col0, int tl, int bar,
                                          int base, bool first_staged) {
  constexpr int K = TWO ? 2 : 1;         // planes a row
  constexpr int LD = SW ? BM : BN;       // the tile's output columns
  const int nplanes = K * nrows;
  for (int pc = 0; pc < nplanes; pc += STAGE_PLANES) {
    const int8_t* view = src + (size_t)pc * TILE;
    if (!RESIDENT && pc == 0 && first_staged) {
      view = stage;                     // prefetched (prefetch)
    } else if (!RESIDENT) {
      const size_t plane = (size_t)m * n;
      constexpr int CPR = LD / 16;       // 16-byte chunks a row
      const int srow = tl / CPR, scol = 16 * (tl % CPR);
      const bool vec = n % 16 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
      const int8_t* g = src + (size_t)(row0 + srow) * n + col0 + scol;
      const long long avail = row0 + srow < m ? (long long)n - (col0 + scol) : 0;
      uint4 v[STAGE_PLANES];
#pragma unroll
      for (int q = 0; q < STAGE_PLANES; ++q)
        if (pc + q < nplanes) v[q] = digit_mma::load16(g + (pc + q) * plane, avail, vec);
      wg_sync(bar);                     // the last chunk's reads are done
#pragma unroll
      for (int q = 0; q < STAGE_PLANES; ++q)
        if (pc + q < nplanes)
          *reinterpret_cast<uint4*>(stage + q * TILE + srow * LD + scol) = v[q];
      wg_sync(bar);
      view = stage;
    }
    const int r1 = min(nrows, (pc + STAGE_PLANES) / K);
#pragma unroll 1
    for (int r = pc / K; r < r1; ++r) {
      const int8_t* p0 = view + (K * r - pc) * TILE + base;
      int32_t v[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        v[x] = p0[tile_const<SW>(x, LD)];
        if (TWO) v[x] += 256 * (int32_t)p0[TILE + tile_const<SW>(x, LD)];
      }
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int32_t wt = sN[r * ND + c];
#pragma unroll
        for (int x = 0; x < 16; ++x)
          acc[4 * (4 * c + (x >> 1 & 3)) + 2 * (x >> 3) + (x & 1)] += v[x] * wt;
      }
    }
  }
}

// The noise planes' rows lie on 16 bytes: the first chunk is prefetched.
__device__ __forceinline__ bool planes_aligned(const Epilogue& E, const int8_t* noise) {
  return E.n % 16 == 0 && (reinterpret_cast<uintptr_t>(noise) & 15) == 0;
}

// Started by a consumer before it contracts a tile, so that they arrive
// during the contraction: cp.async copies into its ``scratch`` of the
// tile's channel's noise table, the tile's scalars and (kernel 1, rows on
// 16 bytes) the tile's first STAGE_PLANES noise planes, zero outside. The
// epilogue waits for them.
template <int ND, bool SW, bool RESIDENT>
__device__ __forceinline__ void prefetch(const Epilogue& E, const int8_t* noise, int ch,
                                         int a0, int b0, int tl, uint8_t* scratch) {
  constexpr int LD = SW ? BM : BN;
  const int row0 = SW ? b0 : a0, col0 = SW ? a0 : b0;
  if (E.nrows > 0) {
    const int32_t* nt = E.ntab + (size_t)ch * E.nrows * ND;
    int32_t* sN = reinterpret_cast<int32_t*>(scratch);
#pragma unroll
    for (int q = 0; q < MAX_ROWS * 8 / 128; ++q)
      if (tl + 128 * q < E.nrows * ND) cp_async4(sN + tl + 128 * q, nt + tl + 128 * q);
  }
  if (E.sc != nullptr) {
    int64_t* ssc = reinterpret_cast<int64_t*>(scratch + TABLE_BYTES);
#pragma unroll 4
    for (int q = 0; q < TILE / 128; ++q) {
      const int e = tl + 128 * q, r = e / LD, c = e % LD;
      if (row0 + r < E.m && col0 + c < E.n)
        cp_async8(ssc + e, E.sc + (size_t)(row0 + r) * E.n + col0 + c);
    }
  }
  if (!RESIDENT && E.nrows > 0 && planes_aligned(E, noise)) {
    int8_t* stage = reinterpret_cast<int8_t*>(scratch + TABLE_BYTES + SC_BYTES);
    constexpr int CPR = LD / 16;
    const int srow = tl / CPR, scol = 16 * (tl % CPR);
    const int nplanes = E.vals && E.jr == 2 ? 2 * E.nrows : E.nrows;
    const bool in_rows = row0 + srow < E.m;
    const int bytes = in_rows ? max(0, min(16, E.n - (col0 + scol))) : 0;
    const int8_t* g = noise + (in_rows ? (size_t)(row0 + srow) * E.n + col0 + scol : 0);
    const size_t plane = (size_t)E.m * E.n;
#pragma unroll
    for (int q = 0; q < STAGE_PLANES; ++q)
      if (q < nplanes)
        cp_async16(stage + q * TILE + srow * LD + scol, g + (bytes ? q * plane : 0), bytes);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The epilogue of one tile from the consumer's registers: noise MAC into the
// nd columns, fold, post, encode, int64 stores. A thread (``tl`` of its
// warpgroup) holds rows 16w + g + 8h of A and columns 8i + 2t + e of each B
// plane c at acc[4 * (4c + i) + 2h + e]; its output x = 8h + 2i + e. Output
// (row, col) is (A row, B column), or (B column, A row) in the swapped form
// ``SW``. The noise planes: ``noise`` [R, m, n] in device memory, or
// ``RESIDENT`` in shared memory ([R][TILE], kernel 3's). What ``prefetch``
// put in the consumer's ``scratch`` (scratch_bytes, its named barrier
// ``bar``) is waited for first; the noise planes past the first chunk are
// staged there, each chunk's loads in flight together; then for each
// FOLD_GROUP of a thread's 16 outputs (fewer at once bound the registers
// beside the accumulators) the fold, ``post`` (its loads in flight together,
// clamped to the tile's origin outside the output), the encode and the
// stores.
template <int ND, bool SW, bool RESIDENT>
__device__ __forceinline__ void epilogue(int32_t (&acc)[16 * ND], const Epilogue& E,
                                         const int8_t* noise, int ch, int a0, int b0, int tl,
                                         uint8_t* scratch, int bar) {
  using digit_mma::Encode;
  using digit_mma::Fold;
  constexpr int LD = SW ? BM : BN;                         // the tile's output columns
  const int w = tl / 32, lane = tl % 32, g = lane / 4, t = lane % 4;
  const int row0 = SW ? b0 : a0, col0 = SW ? a0 : b0;     // the tile's output origin
  // output x at tile row lr(x), column lc(x); bit x of ``in``: inside the
  // output; o(x): its offset in an output plane (the origin's outside;
  // planes hold fewer than 2^31 outputs)
  const auto lr = [&](int x) {
    return SW ? 8 * (x >> 1 & 3) + 2 * t + (x & 1) : 16 * w + g + 8 * (x >> 3);
  };
  const auto lc = [&](int x) {
    return SW ? 16 * w + g + 8 * (x >> 3) : 8 * (x >> 1 & 3) + 2 * t + (x & 1);
  };
  unsigned in = 0;
#pragma unroll
  for (int x = 0; x < 16; ++x)
    in |= (unsigned)(row0 + lr(x) < E.m && col0 + lc(x) < E.n) << x;
  const int origin = row0 * E.n + col0;
  const auto o = [&](int x) { return (in >> x & 1) ? origin + lr(x) * E.n + lc(x) : origin; };
  asm volatile("cp.async.wait_all;" ::: "memory");
  wg_sync(bar);                         // every thread's prefetched bytes are in

  if (E.nrows > 0) {
    const int32_t* sN = reinterpret_cast<const int32_t*>(scratch);
    int8_t* stage = reinterpret_cast<int8_t*>(scratch + TABLE_BYTES + SC_BYTES);
    const int base = lr(0) * LD + lc(0);
    const bool first = planes_aligned(E, noise);
    if (E.vals && E.jr == 2)
      noise_mac<ND, SW, true, RESIDENT>(acc, sN, E.nrows, noise, stage, E.m, E.n, row0, col0,
                                        tl, bar, base, first);
    else
      noise_mac<ND, SW, false, RESIDENT>(acc, sN, E.nrows, noise, stage, E.m, E.n, row0,
                                         col0, tl, bar, base, first);
  }

  const Fold fold(E.tables + (size_t)ch * digit_mma::TAB);
  const size_t plane = (size_t)E.m * E.n;
  int64_t* out = E.out + ch * plane;
#pragma unroll
  for (int x0 = 0; x0 < 16; x0 += FOLD_GROUP) {
    uint64_t res[FOLD_GROUP];
#pragma unroll
    for (int y = 0; y < FOLD_GROUP; ++y) {
      const int x = x0 + y;
      int32_t p[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c)
        p[c] = acc[4 * (4 * c + (x >> 1 & 3)) + 2 * (x >> 3) + (x & 1)];
      res[y] = fold(p);
    }
    if (E.post != nullptr) {
      const int64_t* post = E.post + ch * plane;
      int64_t pv[FOLD_GROUP];
#pragma unroll
      for (int y = 0; y < FOLD_GROUP; ++y) pv[y] = post[o(x0 + y)];
#pragma unroll
      for (int y = 0; y < FOLD_GROUP; ++y) res[y] = addmod(res[y], (uint64_t)pv[y], fold.q);
    }
    if (E.sc != nullptr) {
      const Encode encode(E.etab + (size_t)ch * 3);
      const int64_t* ssc = reinterpret_cast<const int64_t*>(scratch + TABLE_BYTES);
      int64_t sv[FOLD_GROUP];
#pragma unroll
      for (int y = 0; y < FOLD_GROUP; ++y) sv[y] = ssc[lr(x0 + y) * LD + lc(x0 + y)];
#pragma unroll
      for (int y = 0; y < FOLD_GROUP; ++y)
        if (E.mask.keeps(row0 + lr(x0 + y)))
          res[y] = addmod(res[y], encode((uint64_t)sv[y], E.encode32, fold.q), fold.q);
    }
    // the pairs y, y + 1 (e = 0, 1): neighbouring columns, one 16-byte store
    // where aligned; in the swapped form neighbouring rows
#pragma unroll
    for (int y = 0; y < FOLD_GROUP; y += 2) {
      const int x = x0 + y;
      if (!SW && (in >> x & 3) == 3 && (ch * plane + o(x)) % 2 == 0) {
        *reinterpret_cast<longlong2*>(out + o(x)) =
            make_longlong2((long long)res[y], (long long)res[y + 1]);
      } else {
        if (in >> x & 1) out[o(x)] = (int64_t)res[y];
        if (in >> (x + 1) & 1) out[o(x + 1)] = (int64_t)res[y + 1];
      }
    }
  }
  wg_sync(bar);                         // the scratch is free for the next prefetch
}

// ---- host side -------------------------------------------------------------

// An operand in device memory: int8, k contiguous, the other strides in bytes
// (multiples of 16): A [CH, rows, kd] (row, ch), B [CH, nd, cols, kd] (row,
// plane, ch).
struct Operand {
  const void* ptr;
  long long row, plane, ch;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, through the runtime's entry-point
// lookup (so the library needs no -lcuda); null if the installed CUDA lacks it
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return (EncodeTiled) nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return (EncodeTiled) nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : (EncodeTiled) nullptr;
  }();
  return fn;
}

inline bool strides_ok(const Operand& o, bool planes) {
  return (reinterpret_cast<uintptr_t>(o.ptr) & 15) == 0 && o.row > 0 && o.row % 16 == 0 &&
         o.ch > 0 && o.ch % 16 == 0 && (!planes || (o.plane > 0 && o.plane % 16 == 0));
}

// The two tensor maps of a contraction: A boxes [64 rows x 128 k], B boxes
// [nd planes x 32 columns x 128 k], 128-byte swizzle, zero fill outside.
// Returns a CUDA error code (0 on success).
inline int make_maps(CUtensorMap* ma, CUtensorMap* mb, const Operand& a, const Operand& b,
                     int ch, int rows, int cols, int kd, int nd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (!strides_ok(a, false) || !strides_ok(b, true)) return (int)cudaErrorInvalidValue;
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const cuuint64_t adim[3] = {(cuuint64_t)kd, (cuuint64_t)rows, (cuuint64_t)ch};
  const cuuint64_t astr[2] = {(cuuint64_t)a.row, (cuuint64_t)a.ch};
  const cuuint32_t abox[3] = {KT, BM, 1};
  const cuuint64_t bdim[4] = {(cuuint64_t)kd, (cuuint64_t)cols, (cuuint64_t)nd, (cuuint64_t)ch};
  const cuuint64_t bstr[3] = {(cuuint64_t)b.row, (cuuint64_t)b.plane, (cuuint64_t)b.ch};
  const cuuint32_t bbox[4] = {KT, BN, (cuuint32_t)nd, 1};
  if (encode(ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(a.ptr), adim, astr, abox,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS ||
      encode(mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(b.ptr), bdim, bstr, bbox,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Ring stages that fit beside ``extra`` bytes (at most MAX_STAGES; 0 if
// fewer than two fit).
template <int ND>
constexpr int ring_stages(int extra) {
  const int s = (MAX_SMEM - SMEM_SLACK - extra) / stage_bytes<ND>();
  return s < 2 ? 0 : (s > MAX_STAGES ? MAX_STAGES : s);
}

template <int ND>
constexpr int smem_bytes(int stages, int extra) {
  return SMEM_SLACK + stages * stage_bytes<ND>() + extra;
}

}  // namespace wgmma_digit
