#!/usr/bin/env python3
"""Time variants of the fused matmul kernel against the committed source.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 probes/fused_matmul_variants.py [variant ...]

Each variant is the committed ``pvw_tpu_torch/csrc/fused_scaled_noise_matmul.cu``
with some ``constexpr int`` constants replaced and some lines rewritten
(``VARIANTS`` below; no names: all of them). Every variant is built with
nvcc (all at once, ``-Xptxas -v`` for registers and spills) into
``build/variants`` and launched through the port's own wrapper at the toy
chain's c2 shape (16 channels, m = n = 4096, kd = 1280, nd = 5) and
config 4's (272 channels, m = n = 1024, kd = 4096, nd = 8), 32-bit encode:
CUDA events, median of 5. The committed kernel is also held against its
plain twin and timed without the noise and the encode. The ablations
(``no_mma``, ``no_stage``, ``no_transpose``) compute wrong residues on
purpose: they show which part of the kernel bounds its time. One JSON line
per build and per timing.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = ROOT / "pvw_tpu_torch" / "csrc" / "fused_scaled_noise_matmul.cu"
NO_STAGE = [("    if (k0 + KT < kd) load(k0 + KT);", ""),
            ("    store();\n    __syncthreads();", "    if (k0 == 0) store();\n    __syncthreads();")]
VARIANTS = {
    # tilings
    "bm64": {"BM": 64},
    "kt32": {"KT": 32},
    # ablations: wrong residues, for where the time goes
    "no_mma": {"raw": [("mma_s8(acc[c][j], a0, a1, a2, a3, b[0], b[4 * SB]);",
                        "acc[c][j][0] += (int32_t)(a0 ^ a1 ^ a2 ^ a3 ^ b[0] ^ b[4 * SB]);")]},
    "no_stage": {"raw": NO_STAGE},
    "no_transpose": {"raw": [(
        "      transpose_bytes(x, o);\n      transpose_bytes(y, o + 4);\n"
        "      transpose_bytes(z, o + 8);\n      transpose_bytes(w, o + 12);",
        "      for (int i = 0; i < 4; ++i) {\n"
        "        o[i] = x[i]; o[4 + i] = y[i]; o[8 + i] = z[i]; o[12 + i] = w[i];\n      }")]},
}


def variant_source(spec: dict) -> str:
    src = SOURCE.read_text()
    for old, new in spec.get("raw", []):
        if old not in src:
            raise RuntimeError(f"variant text not in the source: {old!r}")
        src = src.replace(old, new)
    for name, value in spec.items():
        if name == "raw":
            continue
        src, count = re.subn(rf"constexpr int {name} = [^;]+;",
                             f"constexpr int {name} = {value};", src)
        if count != 1:
            raise RuntimeError(f"constant {name} not found once in the source")
    return src


def build(names) -> dict:
    """name -> ctypes function, every source compiled at once."""
    from pvw_tpu_torch.ops import _build

    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out_dir / f"{name}.cu"
        src.write_text(SOURCE.read_text() if name == "committed"
                       else variant_source(VARIANTS[name]))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(SOURCE.parent), "-o", str(out_dir / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.emit({"variant": name, "nvcc_rc": proc.returncode,
                 "registers": re.findall(r"Used (\d+) registers", log),
                 "spill_bytes": re.findall(r"(\d+) bytes spill stores", log)})
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).pvw_fused_scaled_noise_matmul
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv) -> int:
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    if not torch.cuda.is_available():
        print("fused_matmul_variants: no CUDA card", file=sys.stderr)
        return 2
    names = argv or list(VARIANTS)
    fns = build(["committed", *names])
    dev = torch.device("cuda")
    card = cs.card_line()
    shapes = [("toy c2", get_ring(cs.MODULI, cs.ELL), cs.N_RECEIVERS, cs.K_DIM),
              ("config-4 c2", get_ring(generate_ntt_primes(61, 17, cs.DEEP_ELL), cs.DEEP_ELL),
               cs.DEEP_N, cs.DEEP_K)]
    for label, ring, m, k in shapes:
        gen = torch.Generator(device=dev).manual_seed(2)
        lhs_dig, band, noise, bound, enc = cs.operands(ring, m, k, m, 1, "enc32", gen, dev)
        for name, fn in fns.items():
            fm._kernel_fn = lambda fn=fn: fn

            def run():
                return fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc,
                                             lhs_dig=lhs_dig, encode32=True,
                                             noise_bound=bound)

            rec = {"shape": label, "variant": name, "card": card,
                   "ms": cs.cuda_ms(run, reps=5)}
            if name == "committed":
                rec["max_abs_err_vs_twin"] = cs.max_abs_err(
                    run(), cs.fold_plain_by_limb(ring, band, lhs_dig, noise, enc))
                rec["ms_without_noise_and_encode"] = cs.cuda_ms(
                    lambda: fm.matmul_fold_scaled(None, band, ring, lhs_dig=lhs_dig), reps=5)
            cs.emit(rec)
        del lhs_dig, band, noise, enc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
