"""Build the port's CUDA sources with nvcc, load them with ctypes and
launch their C entries.

Each ``csrc/<name>.cu`` exports a plain C function and is compiled on its
own into ``build/kernels/<name>-<hash>.so`` beside the package (the hash
covers the source, the shared headers and the flags, so an edited source
rebuilds). Builds
happen at first use, or up front with :func:`build_all`, which starts one
nvcc per source at once. A failed build raises with nvcc's output; there is
no fallback. nvcc's output is kept beside each library
(``<name>-<hash>.log``), from which :func:`ptxas_report` reads each
kernel's registers and spills, for a cached library as for a fresh one.

Every launch wrapper of the port (``ops/``, ``crypto/``, ``benchmarks/``)
takes its C entry from :func:`bind` and calls it through :func:`launch`;
the wrappers that count their launches register the count in
:data:`counters` when their module is imported. Nothing here loads a
library at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}

#: (wrapper, attribute) of each kernel's launch count, by kernel name, as
#: the wrappers' modules register them (:func:`count_launches`); the probes'
#: kernels count on their own wrappers, outside it.
counters: dict[str, tuple] = {}


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
        log_tmp = tmp.with_suffix(".log")
        log_tmp.write_text(log)
        os.replace(log_tmp, out.with_suffix(".log"))
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


def ptxas_report(name: str) -> list[dict]:
    """Each kernel of the current library of ``csrc/<name>.cu``: its
    template arguments (from the mangled name), registers a thread and
    bytes of spill stores and loads, as ``-Xptxas -v`` printed them into
    the build's log ([] before the library is built)."""
    log = target(name).with_suffix(".log")
    out = []
    for entry in re.split(r"Compiling entry function",
                          log.read_text() if log.exists() else "")[1:]:
        mangled = re.match(r"\s*'(\S+)'", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        out.append({"entry": mangled.group(1) if mangled else None,
                    "template_args": [int(a) for a in re.findall(
                        r"Li(\d+)E", mangled.group(1) if mangled else "")],
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None,
                    "spill_load_bytes": int(spill.group(2)) if spill else None})
    return out


def bind(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` (built and loaded at its
    first call), typed by ``argtypes`` (its whole C signature, the stream
    last) and returning a CUDA error code. ctypes keeps one function object
    a symbol of a loaded library, so its types are set once."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def ptr(t):
    """A tensor's data pointer as a C argument (None for None)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def launch(name: str, fn, dev, *args) -> None:
    """Call a kernel's C entry ``fn(*args, stream)`` with ``dev`` current and
    its current stream; raise on a CUDA error."""
    with torch.cuda.device(dev):
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def check_args(dev, args: dict) -> None:
    """Raise unless every (tensor, dtype, shape) of ``args`` is contiguous
    on ``dev`` with that dtype and shape; None entries are skipped."""
    for name, (t, dtype, shape) in args.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def count_launches(name: str, fn, attr: str = "launches") -> None:
    """Start ``fn.<attr>`` at 0 and register it in :data:`counters` as
    kernel ``name``'s launch count."""
    setattr(fn, attr, 0)
    counters[name] = (fn, attr)


def launch_counters() -> dict:
    """(wrapper, attribute) of the launch count of each registered kernel,
    by kernel name: the kernels of ``ops/fused_modmat`` (kernel 1's masked
    and bare launches also among its own) and the device decode's."""
    return dict(counters)
