"""ctypes bridge to the C++ decode engine (``native/pvw_decode.cpp``).

The counterpart of ``pvw_tpu.utils.native_decode``, over the same source.
The engine is built at first use with ``g++ -O3 -shared -fPIC -fopenmp
-std=c++17`` into the git-ignored ``build/native/libpvw_decode.so`` (rebuilt
when the source is newer; ``native/`` belongs to the JAX package, which
builds its own library there). A failed build raises with the compiler's
output: there is no quiet fallback to the Python decode. The engine covers
Δ < 2^63 and q of at most ``MAX_NW`` 64-bit words; the full host decryption
also needs every modulus below 2^62. Outside those, and under
``settings.no_native``, :func:`decrypt_decode_supported` is False and the
decode functions return None.

Two entries: :func:`decode_batch_native` decodes PowerBasis residues
(uint64 [d, L, l]); :func:`decrypt_decode_pairs_native` runs the whole
decryption, <s, c1> - c2, the inverse NTT and the decode, on the host from
c1 and c2 as uint32 (hi, lo) pairs in the canonical layouts.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "pvw_decode.cpp"
_SO = _REPO_ROOT / "build" / "native" / "libpvw_decode.so"
_CXXFLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")
_lock = threading.Lock()

MAX_NW = 18


def _build() -> Path:
    """The engine's library, compiled first when it is missing or older
    than its source; raises RuntimeError with the compiler's output."""
    so = _SO
    if so.exists() and so.stat().st_mtime >= _SRC.stat().st_mtime:
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    # a per-process name, then one rename: concurrent builds never load a
    # half-written library
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_CXXFLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the C++ decode engine did not build ({' '.join(cmd)}): "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the C++ decode engine did not build ({' '.join(cmd)}, "
                           f"exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, so)
    return so


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    with _lock:
        path = _build()
    lib = ctypes.CDLL(str(path))
    p64 = ctypes.POINTER(ctypes.c_uint64)
    p32 = ctypes.POINTER(ctypes.c_uint32)
    lib.pvw_decode_batch.restype = ctypes.c_int
    lib.pvw_decode_batch.argtypes = [
        p64,                              # residues
        ctypes.c_int64,                   # count
        ctypes.c_int32,                   # L
        ctypes.c_int32,                   # ell
        p64, p64, p64, p64, p64,          # moduli, qhat_inv, qhat/q/dpow words
        ctypes.c_int32,                   # nw
        ctypes.c_uint64,                  # delta
        p64,                              # out
    ]
    lib.pvw_decrypt_decode_pairs.restype = ctypes.c_int
    lib.pvw_decrypt_decode_pairs.argtypes = [
        p64, p32, p32, p32, p32,          # sk, c1 hi/lo, c2 hi/lo
        ctypes.c_int64,                   # d
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # k, L, ell
        p64,                              # moduli
        p64,                              # ntt_inv
        p64, p64, p64, p64,               # qhat_inv/qhat_words/q/dpow words
        ctypes.c_int32,                   # nw
        ctypes.c_uint64,                  # delta
        p64,                              # out
    ]
    return lib


def library_path() -> Path:
    """Where the engine's library is built."""
    return _SO


def _words(x: int, nw: int) -> np.ndarray:
    out = np.zeros(nw, np.uint64)
    for i in range(nw):
        out[i] = x & 0xFFFFFFFFFFFFFFFF
        x >>= 64
    if x:
        raise OverflowError("value exceeds word budget")
    return out


@lru_cache(maxsize=16)
def _ctx_tables(params):
    """The per-params constant tables of the C calls, or None where the
    engine does not cover the parameters (Δ >= 2^63, q over MAX_NW words)."""
    ring = params.ring
    q = params.q_total()
    nw = (q.bit_length() + 63) // 64
    if nw > MAX_NW:
        return None
    delta = params.delta()
    if delta >= 1 << 63:
        return None
    moduli = np.array(ring.moduli, np.uint64)
    qhat_inv = np.array(ring.crt.qhat_inv, np.uint64)
    qhat_words = np.ascontiguousarray(np.stack([_words(h, nw) for h in ring.crt.qhat]))
    q_words = _words(q, nw)
    dpow_words = _words(params.delta_power_l_minus_1() % q, nw)
    return moduli, qhat_inv, qhat_words, q_words, dpow_words, nw, delta


@lru_cache(maxsize=16)
def _inv_tables(ring):
    """Stacked inverse-NTT matrices uint64 [L, l, l] for the host decrypt."""
    return np.ascontiguousarray(np.stack([lp.ntt_inv for lp in ring.limbs]), dtype=np.uint64)


def _enabled() -> bool:
    from ..config import settings

    return not settings.no_native


def decode_supported(params) -> bool:
    """True when :func:`decode_batch_native` decodes this parameter set:
    the engine enabled, Δ < 2^63 and q within the word budget."""
    return _enabled() and _ctx_tables(params) is not None


def decrypt_decode_supported(params) -> bool:
    """True when the full host decryption (:func:`decrypt_decode_pairs_native`)
    runs this parameter set: :func:`decode_supported`, and every modulus
    below 2^62 (the lazy accumulator's headroom). Decided from the
    parameters and ``settings.no_native`` alone; the library is built at
    the first decode."""
    return decode_supported(params) and all(m < 1 << 62 for m in params.ring.moduli)


@lru_cache(maxsize=16)
def _decrypt_static_args(params):
    """Pre-marshalled ctypes pointers of the per-params tables; the cache
    entry also owns the arrays, which keeps the pointers alive."""
    tables = _ctx_tables(params)
    if tables is None or any(m >= 1 << 62 for m in params.ring.moduli):
        return None
    moduli, qhat_inv, qhat_words, q_words, dpow_words, nw, delta = tables
    inv = _inv_tables(params.ring)
    p64 = ctypes.POINTER(ctypes.c_uint64)
    return (moduli.ctypes.data_as(p64), inv.ctypes.data_as(p64),
            qhat_inv.ctypes.data_as(p64), qhat_words.ctypes.data_as(p64),
            q_words.ctypes.data_as(p64), dpow_words.ctypes.data_as(p64),
            nw, delta, (moduli, inv, qhat_inv, qhat_words, q_words, dpow_words))


def decrypt_decode_pairs_native(sk_res: np.ndarray, c1h, c1l, c2h, c2l,
                                params) -> list[int] | None:
    """The whole decryption on the host: sk_res uint64 [k, L, l] (NTT),
    c1 as uint32 (hi, lo) [k, d, L, l], c2 as uint32 (hi, lo) [d, L, l]
    -> d messages. None where :func:`decrypt_decode_supported` is False."""
    if not decrypt_decode_supported(params):
        return None
    lib = _lib()
    statics = _decrypt_static_args(params)
    # .ctypes.data of a strided array is its base buffer in the wrong order
    sk_res = np.ascontiguousarray(sk_res, np.uint64)
    c1h = np.ascontiguousarray(c1h, np.uint32)
    c1l = np.ascontiguousarray(c1l, np.uint32)
    c2h = np.ascontiguousarray(c2h, np.uint32)
    c2l = np.ascontiguousarray(c2l, np.uint32)
    k, d = c1h.shape[0], c1h.shape[1]
    L, l = params.ring.num_limbs, params.l
    if (sk_res.shape != (k, L, l) or c1h.shape != (k, d, L, l) or c1l.shape != c1h.shape
            or c2h.shape != (d, L, l) or c2l.shape != c2h.shape):
        raise ValueError(f"host decrypt shapes sk {sk_res.shape}, c1 {c1h.shape}/"
                         f"{c1l.shape}, c2 {c2h.shape}/{c2l.shape} do not fit "
                         f"k={k}, d={d}, L={L}, l={l}")
    out = np.zeros(d, np.uint64)
    p64 = ctypes.POINTER(ctypes.c_uint64)
    p32 = ctypes.POINTER(ctypes.c_uint32)
    rc = lib.pvw_decrypt_decode_pairs(
        sk_res.ctypes.data_as(p64),
        c1h.ctypes.data_as(p32), c1l.ctypes.data_as(p32),
        c2h.ctypes.data_as(p32), c2l.ctypes.data_as(p32),
        d, k, L, l, *statics[:8], out.ctypes.data_as(p64))
    if rc != 0:
        raise RuntimeError(f"pvw_decrypt_decode_pairs refused {params!r} (rc {rc})")
    return [int(v) for v in out]


def decode_batch_native(residues: np.ndarray, params) -> list[int] | None:
    """Decode PowerBasis residues uint64 [d, L, l] (any int64 array is
    taken as its uint64 bit patterns). None where :func:`decode_supported`
    is False."""
    if not decode_supported(params):
        return None
    lib = _lib()
    moduli, qhat_inv, qhat_words, q_words, dpow_words, nw, delta = _ctx_tables(params)
    res = np.ascontiguousarray(residues)
    if res.dtype == np.int64:
        res = res.view(np.uint64)
    res = np.ascontiguousarray(res, np.uint64)
    L, l = params.ring.num_limbs, params.l
    if res.ndim != 3 or res.shape[1:] != (L, l):
        raise ValueError(f"residues {res.shape} are not [d, L={L}, l={l}]")
    d = res.shape[0]
    out = np.zeros(d, np.uint64)
    p64 = ctypes.POINTER(ctypes.c_uint64)
    rc = lib.pvw_decode_batch(
        res.ctypes.data_as(p64), d, L, l,
        moduli.ctypes.data_as(p64), qhat_inv.ctypes.data_as(p64),
        qhat_words.ctypes.data_as(p64), q_words.ctypes.data_as(p64),
        dpow_words.ctypes.data_as(p64), nw, delta, out.ctypes.data_as(p64))
    if rc != 0:
        raise RuntimeError(f"pvw_decode_batch refused {params!r} (rc {rc})")
    return [int(v) for v in out]
