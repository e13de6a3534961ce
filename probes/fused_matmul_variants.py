#!/usr/bin/env python3
"""Time variants of the fused matmul kernels against the committed sources.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 probes/fused_matmul_variants.py [variant ...]

Each variant is the committed kernel 1 (``csrc/fused_scaled_noise_matmul.cu``)
or pipelined kernel 3 (``csrc/fused_pipelined_matmul.cu``) with some lines of
its source or of the shared ``csrc/digit_mma.cuh`` rewritten (``VARIANTS``
below; no names: all of them). Every variant is built with nvcc (all at
once, ``-Xptxas -v`` for registers and spills) into ``build/variants`` and
launched through the port's own wrapper at the toy chain's c2 shape (16
channels, m = n = 4096, kd = 1280, nd = 5) and config 4's (272 channels,
m = n = 1024, kd = 4096, nd = 8), 32-bit encode, bound 50: kernel 1 with noise
planes, kernel 3 with the v3k noise drawn in it; CUDA events, median of 5.
The committed kernels are also held against their plain twins, kernel 1 is
timed without the noise and the encode and in its swapped form. The
ablations (``no_*``) compute wrong residues on purpose: they show which part
of a kernel bounds its time. One JSON line per build and per timing.
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
HEADER = "digit_mma.cuh"
NO_STAGE = [("    if (k0 + KT < kd) load(k0 + KT);  // in flight while the tensor cores run", ""),
            ("    store();\n    sync();", "    if (k0 == 0) store();\n    sync();")]
# name -> (kernel source, {file: [(old text, new text), ...]})
COMMITTED = {"kernel1": (KERNEL1, {}), "pipelined": (PIPELINED, {})}
VARIANTS = {
    # kernel 1 tilings
    "bm64": (KERNEL1, {KERNEL1: [("SW ? 32 : 128;   // output rows", "SW ? 32 : 64;   // output rows")]}),
    "kt32": (KERNEL1, {HEADER: [("constexpr int KT = 64;", "constexpr int KT = 32;")]}),
    # kernel 1 ablations: wrong residues, for where the time goes
    "no_mma": (KERNEL1, {HEADER: [(
        "mma_s8(acc[c][j], a0, a1, a2, a3, b[0], b[4 * SB]);",
        "acc[c][j][0] += (int32_t)(a0 ^ a1 ^ a2 ^ a3 ^ b[0] ^ b[4 * SB]);")]}),
    "no_stage": (KERNEL1, {HEADER: NO_STAGE}),
    "no_transpose": (KERNEL1, {HEADER: [(
        "      transpose_bytes(x, o);\n      transpose_bytes(y, o + 4);\n"
        "      transpose_bytes(z, o + 8);\n      transpose_bytes(w, o + 12);",
        "      for (int i = 0; i < 4; ++i) {\n"
        "        o[i] = x[i]; o[4 + i] = y[i]; o[8 + i] = z[i]; o[12 + i] = w[i];\n      }")]}),
    # kernel 3 ablations: the tensor-core warps alone, the epilogue warps
    # (and the noise) alone, no in-kernel noise draw
    "p_no_epilogue": (PIPELINED, {PIPELINED: [(
        "for (int i = 0; i < TILE / EPI_THREADS; ++i) {", "for (int i = 0; i < 0; ++i) {")]}),
    "p_no_contraction": (PIPELINED, {PIPELINED: [(
        "      contract_banded<ND, TM, TN, TC_THREADS>(",
        "      if (kd < 0) contract_banded<ND, TM, TN, TC_THREADS>(")]}),
    "p_no_generation": (PIPELINED, {PIPELINED: [("  if (gen) {", "  if (gen && kd < 0) {")]}),
}
SYMBOLS = {KERNEL1: "pvw_fused_scaled_noise_matmul", PIPELINED: "pvw_fused_pipelined_matmul"}


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

    procs = {}
    for name in names:
        kernel, edits = spec(name)
        src = variant_dir(name, kernel, edits) / kernel
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(src.with_suffix(".so")), str(src)]
        procs[name] = (src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, proc) in procs.items():
        log, _ = proc.communicate()
        cs.emit({"variant": name, "nvcc_rc": proc.returncode,
                 "registers": re.findall(r"Used (\d+) registers", log),
                 "spill_bytes": re.findall(r"(\d+) bytes spill stores", log)})
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(src.with_suffix(".so")))
    return libs


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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
