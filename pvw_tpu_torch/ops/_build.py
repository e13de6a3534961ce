"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C function and is compiled on its
own into ``build/kernels/<name>-<hash>.so`` beside the package (the hash
covers the source, the shared headers and the flags, so an edited source
rebuilds). Builds
happen at first use, or up front with :func:`build_all`, which starts one
nvcc per source at once. A failed build raises with nvcc's output; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit PyTorch finds (``CUDA_HOME``, ``CUDA_PATH``,
    ``PATH``, then the toolkit's default install directory)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of pvw_tpu_torch are "
                           "built at first use and need the CUDA toolkit")
    return str(nvcc)


def target(name: str) -> Path:
    """The library path of ``csrc/<name>.cu`` for its current source and
    the shared headers ``csrc/*.cuh``."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names) -> None:
    """Compile every source in ``names`` that has no current library,
    all nvcc processes running at once."""
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        out = target(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path = target(name)
        if not path.exists():
            build_all([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
