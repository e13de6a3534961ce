#!/usr/bin/env python3
"""Time variants of the fused matmul kernels against the committed sources.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 probes/fused_matmul_variants.py [variant ...]

Each variant is the committed kernel 1 (``csrc/fused_scaled_noise_matmul.cu``),
pipelined kernel 3 (``csrc/fused_pipelined_matmul.cu``) or kernel 2
(``csrc/banded_matmul.cu``, the ``k2_*`` variants) with some lines of its
source or of the shared ``csrc/wgmma_digit.cuh`` rewritten (``VARIANTS``
below; no names: all of them). Every variant is built with nvcc (all at
once, ``-Xptxas -v``: registers and spills a kernel) into
``build/variants`` and launched through the port's own wrapper at the toy
chain's c2 shape (16 channels, m = n = 4096, kd = 1280, nd = 5) and config
4's (272 channels, m = n = 1024, kd = 4096, nd = 8), 32-bit encode, bound
50: kernel 1 with noise planes, kernel 3 with the v3k noise drawn in it;
CUDA events, median of 5. The committed kernels are also held against
their plain twins, kernel 1 is timed without the noise and the encode and
in its swapped form, and ``torch._int_mm`` of the same contraction is timed
beside them. Kernel 2's builds run at its two full shapes (chip_smoke.py's
banded ones: 16 channels of [4096 x 256] x [256 x 1024] at nd = 5, 272 of
[1024 x 512] x [512 x 1024] at nd = 8) on one set of digit planes. The ablations (``no_*``, ``epilogue_only``) compute wrong
residues on purpose: they show which part of a kernel bounds its time.
One JSON line per build and per timing.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "pvw_tpu_torch" / "csrc"
KERNEL1 = "fused_scaled_noise_matmul.cu"
PIPELINED = "fused_pipelined_matmul.cu"
HEADER = "wgmma_digit.cuh"
# the tensor cores idle: each k step's wgmma replaced by a register xor
NO_MMA = ("      Wgmma<32 * ND>::template mma<0>(acc, da + 2 * kk, db + 2 * kk, kb | kk);",
          "      acc[kk] += (int32_t)(da ^ db);")
# no bytes moved: the producer arrives on a stage's full barrier without TMA
NO_TMA = ("      mbar_expect_tx(&R.full[s], Ring<ND>::STAGE);\n"
          "      tma_load_3d(R.a(s), ma, &R.full[s], kb * KT, a0, ch);\n"
          "      tma_load_4d(R.b(s), mb, &R.full[s], kb * KT, b0, 0, ch);",
          "      mbar_arrive(&R.full[s]);")
# the epilogue calls of kernels 1 and 3
EPI1 = "      epilogue<ND, SW, false>(acc, E, noise, ch, a0, b0, tl, scratch, BAR_EPI + wg - 1);"
EPI1_END = "tl, scratch, BAR_EPI + wg - 1);"
EPI3 = "      epilogue<ND, false, true>(acc, E, planes, ch, a0, b0, tl, scratch, BAR_EPI + wg - 1);"
TRY_WAIT = "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
NO_EPI1 = (EPI1, "      if (E.m < 0)" + EPI1[5:])
SPIN = (TRY_WAIT, TRY_WAIT.replace("try_wait", "test_wait"))
NO_SETMAXNREG = [('    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");', ""),
                 ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");', "")]
# the trace: a stamp buffer of %globaltimer (ns) readings, block 0's tiles
# (producer, consumers) and the reader pvw_trace_read
TRACE_NS = ("namespace wgmma_digit {\n",
            "namespace wgmma_digit {\n__device__ long long trace_buf[8192];\n"
            "__device__ __forceinline__ long long now() {\n  long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n")
TRACE_TILE = ("    tiles(j, ch, a0, b0);\n",
              "    tiles(j, ch, a0, b0);\n"
              "    if (blockIdx.x == 0 && j < 1024) trace_buf[4096 + j] = now();\n")
TRACE_K1 = [("      contract(acc, R, j, nk, wg - 1, j > 0, j + 1 < count, tl % 32 == 0);",
             "      const bool tr = blockIdx.x == 0 && tl == 0 && j < 1024;\n"
             "      if (tr) trace_buf[4 * j] = now();\n"
             "      contract(acc, R, j, nk, wg - 1, j > 0, j + 1 < count, tl % 32 == 0);\n"
             "      if (tr) trace_buf[4 * j + 1] = now();"),
            (EPI1_END, EPI1_END + "\n      if (tr) trace_buf[4 * j + 2] = now();"),
            ("}  // namespace\n",
             "}  // namespace\n\nextern \"C\" int pvw_trace_read(void* dst) {\n"
             "  return (int)cudaMemcpyFromSymbol(dst, wgmma_digit::trace_buf, "
             "sizeof(long long) * 8192);\n}\n")]
FOLD_GROUP_AT = lambda g: ("constexpr int FOLD_GROUP = 8;", f"constexpr int FOLD_GROUP = {g};")
# kernel 2 (banded_matmul.cu): its window products, its producer's loads
BANDED = "banded_matmul.cu"
K2_MMA = ("        window_products<ND>(acc, da + 2 * kk, db + 2 * kk, "
          "std::make_integer_sequence<int, ND>{});")
K2_NO_MMA = (K2_MMA, "        acc[kk] += (int32_t)(da ^ db);")
K2_NO_TMA = ("        mbar_expect_tx(&full[s], ND * St::A_PLANE + (second ? 2 : 1) * St::B_HALF);\n"
             "        tma_load_4d(a_stage(s), &ma, &full[s], kb * KB, a0, 0, ch);\n"
             "        tma_load_4d(b_half(s, 0), &mb, &full[s], kb * KB, b0, 0, ch);\n"
             "        if (second) tma_load_4d(b_half(s, 1), &mb, &full[s], kb * KB, b0 + HALF, 0, ch);",
             "        mbar_arrive(&full[s]);")
K2_EPI = "    const Fold<C> fold(tables + (size_t)ch * TAB);"
# the exact alternative to the windows: one m64n16k32 a digit pair (i, j),
# nd^2 of them a 32-byte step, each into its own column's 8 registers
K2_PAIRS = [("template <int ND>\n__global__ void",
             "template <int ND, int... P>\n"
             "__device__ __forceinline__ void pair_products(int32_t (&acc)[8 * (2 * ND - 1)], "
             "uint64_t da, uint64_t db, std::integer_sequence<int, P...>) {\n"
             "  (Wgmma<HALF>::template mma<8 * (P / ND + P % ND)>(acc, da + P / ND * "
             "(Stage<ND>::A_PLANE >> 4), db + P % ND * (Stage<ND>::B_PLANE >> 4), 1), ...);\n"
             "}\n\ntemplate <int ND>\n__global__ void"),
            (K2_MMA, "        pair_products<ND>(acc, da + 2 * kk, db + 2 * kk, "
                     "std::make_integer_sequence<int, ND * ND>{});")]
# the same digit-pair products with A from registers: each thread loads its
# fragment of every lhs plane from the swizzled stage once a 32-byte step,
# so the tensor cores read only B (16 rows) from shared memory
K2_REGA_FNS = """template <int OFF, int R>
__device__ __forceinline__ void mma_n16_rega(int32_t (&d)[R], const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %13, 0;\\n"
               "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
               "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\\n}\\n"
               : "+r"(d[OFF]), "+r"(d[OFF + 1]), "+r"(d[OFF + 2]), "+r"(d[OFF + 3]),
                 "+r"(d[OFF + 4]), "+r"(d[OFF + 5]), "+r"(d[OFF + 6]), "+r"(d[OFF + 7])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int ND, int... P>
__device__ __forceinline__ void pair_products_rega(int32_t (&acc)[8 * (2 * ND - 1)],
                                                   const uint32_t (&fa)[ND][4], uint64_t db,
                                                   std::integer_sequence<int, P...>) {
  (mma_n16_rega<8 * (P / ND + P % ND)>(acc, fa[P / ND], db + P % ND * (Stage<ND>::B_PLANE >> 4)),
   ...);
}

template <int ND>
__global__ void"""
K2_REGA = [("template <int ND>\n__global__ void", K2_REGA_FNS),
           ("      wgmma_fence();\n#pragma unroll\n      for (int kk = 0; kk < KB / 32; ++kk)\n" + K2_MMA,
            "#pragma unroll\n"
            "      for (int kk = 0; kk < KB / 32; ++kk) {\n"
            "        uint32_t fa[ND][4];\n"
            "        const int r0 = 16 * w + g, sw = (r0 >> 1) & 3;\n"
            "#pragma unroll\n"
            "        for (int i = 0; i < ND; ++i)\n"
            "#pragma unroll\n"
            "          for (int e = 0; e < 4; ++e)\n"
            "            fa[i][e] = *reinterpret_cast<const uint32_t*>(\n"
            "                a_stage(s) + i * St::A_PLANE + (r0 + 8 * (e & 1)) * KB +\n"
            "                ((2 * kk + (e >> 1)) ^ sw) * 16 + 4 * t);\n"
            "        wgmma_fence();\n"
            "        pair_products_rega<ND>(acc, fa, db + 2 * kk, "
            "std::make_integer_sequence<int, ND * ND>{});\n"
            "      }")]
# the first design: one m64n(16nd)k32 a lhs digit, A = plane i against the
# half's nd planes, into the accumulator columns i..i+nd-1; products into
# overlapping runs of registers are not ordered in flight, so its sums are
# wrong at nd >= 2 (``bit_exact_vs_committed`` false)
K2_SLICES = [("template <int ND>\n__global__ void",
              "template <int ND, int... I>\n"
              "__device__ __forceinline__ void slice_products(int32_t (&acc)[8 * (2 * ND - 1)], "
              "uint64_t da, uint64_t db, std::integer_sequence<int, I...>) {\n"
              "  (Wgmma<HALF * ND>::template mma<8 * I>(acc, da + I * (Stage<ND>::A_PLANE >> 4), "
              "db, 1), ...);\n"
              "}\n\ntemplate <int ND>\n__global__ void"),
             (K2_MMA, "        slice_products<ND>(acc, da + 2 * kk, db + 2 * kk, "
                      "std::make_integer_sequence<int, ND>{});")]
# name -> (kernel source, {file: [(old text, new text), ...]})
COMMITTED = {"kernel1": (KERNEL1, {}), "pipelined": (PIPELINED, {}), "kernel2": (BANDED, {})}
VARIANTS = {
    # kernel 1 ring depth
    "stages4": (KERNEL1, {HEADER: [("constexpr int MAX_STAGES = 8;", "constexpr int MAX_STAGES = 4;")]}),
    "stages2": (KERNEL1, {HEADER: [("constexpr int MAX_STAGES = 8;", "constexpr int MAX_STAGES = 2;")]}),
    # kernel 1 traced: block 0's consumers stamp %globaltimer (ns) before and
    # after each tile's contraction and after its epilogue, its producer
    # before each tile's first stage (pvw_trace_read copies them out)
    "trace": (KERNEL1, {HEADER: [TRACE_NS, TRACE_TILE], KERNEL1: TRACE_K1}),
    # the barrier wait: a non-blocking test in a spin loop, or try_wait with
    # a 20 ns suspend-time hint
    "spin_wait": (KERNEL1, {HEADER: [SPIN]}),
    "hint_wait": (KERNEL1, {HEADER: [(TRY_WAIT, TRY_WAIT.replace("%2;", "%2, 20;"))]}),
    # the pipeline alone, traced stage by stage: block 0's producer stamps
    # each of the first 1024 stages after its empty wait, the consumer after
    # its full wait
    "pipe_trace": (KERNEL1, {HEADER: [NO_MMA, NO_TMA, TRACE_NS, TRACE_TILE, (
        "      mbar_wait(&R.empty[s], ((it / R.S) & 1) ^ 1);\n",
        "      mbar_wait(&R.empty[s], ((it / R.S) & 1) ^ 1);\n"
        "      if (blockIdx.x == 0 && it < 1024) trace_buf[6144 + it] = now();\n"), (
        "    mbar_wait(&R.full[s], (it / R.S) & 1);\n",
        "    mbar_wait(&R.full[s], (it / R.S) & 1);\n"
        "    if (blockIdx.x == 0 && lane0 && it < 1024 && threadIdx.x % 128 == 0) trace_buf[5120 + it] = now();\n")],
        KERNEL1: [NO_EPI1, *TRACE_K1]}),
    # kernel 1's walk: the B tile fastest (consecutive blocks share an A tile)
    "walk_b": (KERNEL1, {KERNEL1: [(
        "    a0 = rem % tiles_a * BM;\n    b0 = rem / tiles_a * BN;",
        "    a0 = rem / tiles_b * BM;\n    b0 = rem % tiles_b * BN;")]}),
    # the epilogue folding 4 or 16 of a thread's outputs at a time
    "fold4": (KERNEL1, {HEADER: [FOLD_GROUP_AT(4)]}),
    "fold16": (KERNEL1, {HEADER: [FOLD_GROUP_AT(16)]}),
    "p_fold4": (PIPELINED, {HEADER: [FOLD_GROUP_AT(4)]}),
    # kernel 1 ablations: wrong residues, for where the time goes
    "no_mma": (KERNEL1, {HEADER: [NO_MMA]}),
    "no_tma": (KERNEL1, {HEADER: [NO_TMA]}),
    "epilogue_only": (KERNEL1, {HEADER: [NO_MMA, NO_TMA]}),
    "pipeline_only": (KERNEL1, {HEADER: [NO_MMA, NO_TMA], KERNEL1: [NO_EPI1]}),
    # the pipeline alone: with a spinning wait, without the register split
    "pipe_spin": (KERNEL1, {HEADER: [NO_MMA, NO_TMA, SPIN], KERNEL1: [NO_EPI1]}),
    "pipe_no_setmaxnreg": (KERNEL1, {HEADER: [NO_MMA, NO_TMA], KERNEL1: [NO_EPI1, *NO_SETMAXNREG]}),
    "no_setmaxnreg": (KERNEL1, {KERNEL1: NO_SETMAXNREG}),
    "ep_no_noise": (KERNEL1, {HEADER: [NO_MMA, NO_TMA, (
        "  if (E.nrows > 0) {\n    const int32_t* sN", "  if (E.nrows < 0) {\n    const int32_t* sN")]}),
    "ep_no_fold": (KERNEL1, {HEADER: [NO_MMA, NO_TMA, (
        "      res[y] = fold(p);", "      res[y] = (uint64_t)(p[0] ^ p[ND - 1]);")]}),
    "no_epilogue": (KERNEL1, {KERNEL1: [(
        EPI1, "      if (E.m < 0)" + EPI1[5:])]}),
    # kernel 3 ablations: its contraction alone, its epilogue alone, no
    # in-kernel noise draw
    "p_no_epilogue": (PIPELINED, {PIPELINED: [(
        EPI3, "      if (E.m < 0)" + EPI3[5:])]}),
    "p_epilogue_only": (PIPELINED, {HEADER: [NO_MMA, NO_TMA]}),
    "p_no_generation": (PIPELINED, {PIPELINED: [("    if (gen) {", "    if (gen && l < 0) {")]}),
    # kernel 2: the digit-pair products instead of the windows; its
    # ablations (the tensor cores idle, no bytes moved, both: the epilogue
    # and the barrier pipeline alone; no epilogue)
    "k2_pairs": (BANDED, {BANDED: K2_PAIRS}),
    "k2_pairs_rega": (BANDED, {BANDED: K2_REGA}),
    "k2_slices": (BANDED, {BANDED: K2_SLICES}),
    # a producer warpgroup (384 threads, as kernels 1 and 3): ptxas caps the
    # registers at 168 and spills
    "k2_384": (BANDED, {BANDED: [("constexpr int THREADS2 = 2 * 128 + 32;",
                                  "constexpr int THREADS2 = 3 * 128;")]}),
    "k2_no_mma": (BANDED, {BANDED: [K2_NO_MMA]}),
    "k2_no_tma": (BANDED, {BANDED: [K2_NO_TMA]}),
    "k2_epilogue_only": (BANDED, {BANDED: [K2_NO_MMA, K2_NO_TMA]}),
    "k2_no_epilogue": (BANDED, {BANDED: [(K2_EPI, "    if (m > 0) continue;\n" + K2_EPI)]}),
}
SYMBOLS = {KERNEL1: "pvw_fused_scaled_noise_matmul", PIPELINED: "pvw_fused_pipelined_matmul",
           BANDED: "pvw_banded_matmul"}


def spec(name: str):
    return COMMITTED[name] if name in COMMITTED else VARIANTS[name]


def variant_dir(name: str, kernel: str, edits: dict) -> Path:
    """build/variants/<name>/ holding the kernel source and the shared
    headers, with ``edits`` applied."""
    out = ROOT / "build" / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for path in [CSRC / kernel, *CSRC.glob("*.cuh")]:
        text = path.read_text()
        for old, new in edits.get(path.name, []):
            if old not in text:
                raise RuntimeError(f"variant text not in {path.name}: {old!r}")
            text = text.replace(old, new)
        (out / path.name).write_text(text)
    return out


def build(names) -> dict:
    """name -> loaded library, every source compiled at once."""
    from pvw_tpu_torch.ops import _build

    srcs = {name: variant_dir(name, *spec(name)) / spec(name)[0] for name in names}
    procs = {}
    for name, src in srcs.items():
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(src.with_suffix(".so")), str(src)]
        procs[name] = (src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, proc) in procs.items():
        log, _ = proc.communicate()
        cs.emit({"variant": name, "nvcc_rc": proc.returncode,
                 "registers": re.findall(r"Used (\d+) registers", log),
                 "spill_bytes": re.findall(r"(\d+) bytes spill stores", log),
                 "warnings": sorted(set(re.findall(r"warning.*", log)))})
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(src.with_suffix(".so")))
    return libs


def read_trace(lib) -> dict:
    """Block 0's stamps of the last traced launch, in microseconds from its
    first: per tile j, [contraction start, contraction end, epilogue end]
    (consumer j % 2) and the producer's start of its first stage; the
    first 24 tiles, and the medians of each span."""
    import statistics

    buf = (ctypes.c_longlong * 8192)()
    if lib.pvw_trace_read(buf) != 0:
        raise RuntimeError("pvw_trace_read failed")
    tiles = [j for j in range(1024) if buf[4 * j + 1] > 0]
    t0 = min(buf[4 * j] for j in tiles)
    us = lambda t: round((t - t0) / 1e3, 2) if t else None
    span = lambda a, b: statistics.median((buf[4 * j + b] - buf[4 * j + a]) / 1e3 for j in tiles)
    out = {"tiles": len(tiles),
           "first": [[us(buf[4 * j]), us(buf[4 * j + 1]), us(buf[4 * j + 2]),
                      us(buf[4096 + j])] for j in tiles[:24]],
           "median_wait_and_contract_us": span(0, 1),
           "median_tile_gap_us": statistics.median(
               (buf[4 * (j + 1)] - buf[4 * j]) / 1e3 for j in tiles[:-1])}
    if buf[2]:
        out["median_epilogue_us"] = span(1, 2)
    if buf[5120]:    # per stage: the consumer's full wait done, the producer's empty wait done
        out["stages"] = [[us(buf[5120 + i]), us(buf[6144 + i])] for i in range(96)]
    return out


def main(argv) -> int:
    import torch

    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm, tfry
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    if not torch.cuda.is_available():
        print("fused_matmul_variants: no CUDA card", file=sys.stderr)
        return 2
    names = argv or list(VARIANTS)
    shutil.rmtree(ROOT / "build" / "variants", ignore_errors=True)
    libs = build([*COMMITTED, *names])
    kernel_fn, pipelined_fn = fm._kernel_fn, fm._pipelined_fn
    dev = torch.device("cuda")
    card = cs.card_line()
    shapes = [("toy c2", get_ring(cs.MODULI, cs.ELL), cs.N_RECEIVERS, cs.K_DIM),
              ("config-4 c2", get_ring(generate_ntt_primes(61, 17, cs.DEEP_ELL), cs.DEEP_ELL),
               cs.DEEP_N, cs.DEEP_K)]
    for label, ring, m, k in shapes:
        gen = torch.Generator(device=dev).manual_seed(2)
        lhs_dig, band, noise, bound, enc = cs.operands(ring, m, k, m, 1, "enc32", gen, dev)
        g = ((*cs.V3K_KEY, 0, 0), 1, bound, "tfry")
        for name, lib in libs.items():
            kernel = spec(name)[0]
            if kernel == BANDED:
                continue
            fn = getattr(lib, SYMBOLS[kernel])
            fn.restype = ctypes.c_int
            if kernel == KERNEL1:
                fn.argtypes = fm.KERNEL1_ARGTYPES
                fm._kernel_fn = lambda symbol, fn=fn: fn
            else:
                fn.argtypes = fm.PIPELINED_ARGTYPES
                fm._pipelined_fn = lambda fn=fn: fn

            def run(pipelined: bool = kernel == PIPELINED):
                settings.pipeline_fold = pipelined
                try:
                    if pipelined:
                        return fm.matmul_fold_scaled(None, band, ring, encode=enc,
                                                     lhs_dig=lhs_dig, encode32=True,
                                                     gen_noise=g)
                    return fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc,
                                                 lhs_dig=lhs_dig, encode32=True,
                                                 noise_bound=bound)
                finally:
                    del settings.pipeline_fold

            rec = {"shape": label, "variant": name, "card": card,
                   "ms": cs.cuda_ms(run, reps=5)}
            if name in ("trace", "pipe_trace"):
                rec["trace"] = read_trace(lib)
            if name == "kernel1":
                rec["max_abs_err_vs_twin"] = cs.max_abs_err(
                    run(), cs.fold_plain_by_limb(ring, band, lhs_dig, noise, enc))
                rec["ms_without_noise_and_encode"] = cs.cuda_ms(
                    lambda: fm.matmul_fold_scaled(None, band, ring, lhs_dig=lhs_dig), reps=5)
            elif name == "pipelined":
                planes = tfry.v3k_noise_digit_planes(*cs.V3K_KEY, 0, m, m, ring.degree,
                                                     bound, 0, dev)
                rec["max_abs_err_vs_twin"] = cs.max_abs_err(
                    run(), cs.fold_plain_by_limb(ring, band, lhs_dig, planes, enc))
                del planes
            cs.emit(rec)
            fm._kernel_fn, fm._pipelined_fn = kernel_fn, pipelined_fn
        cs.emit({"shape": label, "variant": "torch._int_mm", "card": card,
                 "ms": cs.cuda_ms(cs.int_mm_banded(ring, lhs_dig, band), reps=5)})
        del lhs_dig, band
        planes, rd, _, _, _ = cs.swapped_operands(ring, m, k, m, 1, "enc32", gen, dev,
                                                  digits_only=True)
        swapped = getattr(libs["kernel1"], "pvw_fused_scaled_noise_matmul_swapped")
        swapped.argtypes, swapped.restype = fm.KERNEL1_ARGTYPES, ctypes.c_int
        fm._kernel_fn = lambda symbol: swapped
        cs.emit({"shape": label, "variant": "kernel1, swapped form", "card": card,
                 "ms": cs.cuda_ms(lambda: fm.matmul_fold_swapped(
                     planes, rd, ring, noise=noise, encode=enc, encode32=True,
                     noise_bound=bound), reps=5)})
        fm._kernel_fn = kernel_fn
        del planes, rd, noise, enc
        torch.cuda.empty_cache()
    time_kernel2({name: lib for name, lib in libs.items() if spec(name)[0] == BANDED}, dev, card)
    return 0


def time_kernel2(libs: dict, dev, card: str) -> None:
    """Kernel 2's builds at its two full shapes (chip_smoke's banded
    ones), launched on one set of k-packed digit planes: median of 5 with
    the spread; each build that is no ablation held against the committed
    kernel's output, itself held against the twin."""
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    banded_fn = fm._banded_fn
    shapes = (("toy", get_ring(cs.MODULI, cs.ELL), *cs.BANDED_TOY),
              ("config-4", get_ring(generate_ntt_primes(61, 17, cs.DEEP_ELL), cs.DEEP_ELL),
               cs.DEEP_N, cs.DEEP_K, cs.DEEP_N))
    for label, ring, m, k, n in shapes:
        L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
        gen = torch.Generator(device=dev).manual_seed(4)
        a, b = cs.residue_pair(ring, m, k, n, gen, dev)
        ap = fm.digit_planes_kpacked(a.reshape(L * S, m, k), nd)
        bp = fm.digit_planes_kpacked(b.reshape(L * S, k, n), nd, transpose=True)
        tables = fm._banded_tables(ring, S, dev)
        want = None
        for name, lib in libs.items():
            fn = lib.pvw_banded_matmul
            fn.argtypes, fn.restype = fm._BANDED_ARGTYPES, ctypes.c_int
            fm._banded_fn = lambda fn=fn: fn
            rec = {"shape": label, "variant": name, "card": card,
                   **cs.kernel_times(lambda: fm.banded_matmul(ap, bp, tables))}
            if name == "kernel2":
                want = fm.banded_matmul(ap, bp, tables)
                rec["max_abs_err_vs_twin"] = cs.max_abs_err(want, cs.channels_plain_by_limb(
                    ring, a, b).reshape(L * S, m, n))
            elif "_no_" not in name and "only" not in name:
                rec["bit_exact_vs_committed"] = bool(torch.equal(
                    fm.banded_matmul(ap, bp, tables), want))
            cs.emit(rec)
        fm._banded_fn = banded_fn
        a_int, b_int = ap.reshape(L * S, nd * m, k), bp.reshape(L * S, nd * n, k)

        def library():
            for c in range(L * S):
                torch._int_mm(a_int[c], b_int[c].t())

        cs.emit({"shape": label, "variant": "torch._int_mm", "card": card,
                 "ms": cs.cuda_ms(library, reps=5)})
        del a, b, ap, bp, a_int, b_int, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
