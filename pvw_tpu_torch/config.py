"""Runtime knobs of the port: the knobs of ``pvw_tpu.config`` that have a
meaning on a CUDA card, under the same environment variables.

===================  ====================  ==================================
Attribute            Env var               Meaning (default)
===================  ====================  ==================================
noise_stream         PVW_TPU_NOISE         Encryption-noise stream:
                                           ``"kernel"``/``"v4"`` and ``"v3"``
                                           draw v3 threefry noise planes (v4
                                           is the TPU's hardware PRNG and
                                           exists on no other device, so the
                                           port routes it as the JAX package
                                           does off the TPU); ``"v3k"``
                                           generates the global-counter v3k
                                           planes (``gen_noise``: a kernel on
                                           the card) and draws the cbd-k r
                                           stream ("kernel").
noise_value_mac      PVW_TPU_NOISE_VALS    Let the fused kernel compose the
                                           noise digit planes into int32
                                           values when the int32 column
                                           headroom allows (True).
decode_mode          PVW_TPU_DECODE        Decode engine, routed as in the JAX
                                           package (``decryption._decode_mode``):
                                           ``"auto"`` sends batches below
                                           ``decode_crossover`` to the host
                                           engine and the rest to the decode
                                           on the residues' device
                                           (``crypto/device_decode.py``);
                                           ``"device"``, ``"host"`` (the whole
                                           decryption in the C++ engine,
                                           ``utils/native_decode.py``),
                                           ``"native"`` (the contraction on the
                                           device, the decode in the C++
                                           engine), ``"python"`` (the exact
                                           Python decode) ("auto").
decode_crossover     PVW_TPU_DECODE_       Batch size below which ``auto``
                     CROSSOVER             decrypts on the host (64: the JAX
                                           package's default, which it
                                           measured on its own device; not a
                                           measurement on a card).
no_native            PVW_TPU_NO_NATIVE     Disable the C++ decode engine
                                           (False).
fused_prescale       PVW_TPU_FUSED_        The JAX package's r-stage engine
                     PRESCALE              choice, parsed as there
                                           (:meth:`use_fused_prescale`) and
                                           read by nothing: the port's
                                           r-stage always takes
                                           ``ntt_prescale_band``, the kernel
                                           on a card and on the CPU its twin,
                                           which is the plain pipeline
                                           ("auto").
swapped_form         PVW_TPU_SWAPPED       Encrypt in the swapped operand
                                           form: the Shoup scales on the
                                           cached key planes, the plain
                                           digits of r as the rhs, kernel 1's
                                           swapped variant
                                           (``_swapped_form_ok``) (False).
pipeline_fold        PVW_TPU_PIPELINE      Run the fused products with noise
                                           or an encode through the pipelined
                                           kernel on a card (the fold of
                                           channel c under the contraction of
                                           channel c + 1, v3k noise drawn in
                                           it) (False).
num_digits           PVW_NUM_DIGITS        Force the int8 digit width of the
                                           ring's decomposition, read when a
                                           ``RingPlan`` is built: a width in
                                           [minimal, 8]; any exact width gives
                                           the same residues (default: the
                                           minimal exact width of the chain).
trace                PVW_TPU_TRACE         Record the spans of
                                           ``utils.profiling.span`` (read at
                                           each span) and write one JSON
                                           line a span to stderr at
                                           ``utils.profiling.flush()`` or at
                                           exit (False).
===================  ====================  ==================================

Precedence per knob: programmatic assignment > environment variable >
default. Booleans: ``0``, ``false``, ``off``, ``no`` are falsy.

The JAX package's Mosaic knobs are left out: ``tile_m``/``tile_n`` and
``vmem_limit_mb`` size Pallas tiles and the TPU's scoped VMEM, ``no_pallas``
routes around Pallas, ``dots_first`` orders the MXU dots inside a Pallas
body, and ``jax_cache_dir`` is JAX's compilation cache. The CUDA kernels
fix their tiles and shared memory at build time, and every route here is
the one kernel or its plain twin, so none of them would select anything.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

_UNSET = object()
_FALSY = frozenset({"0", "false", "off", "no"})
_DECODE_MODES = ("auto", "device", "host", "native", "python")


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() not in _FALSY


class _Knob:
    """One setting: programmatic override > env var > default."""

    def __init__(self, env: str, default, parse: Callable = str) -> None:
        self.env = env
        # the trace knob is read at every span, and os.environ.get raises
        # and catches two KeyErrors for an unset variable (~1.4 us): a knob
        # reads os.environ's own table, which every assignment through
        # os.environ keeps current
        self.key = os.environ.encodekey(env)
        self.default = default
        self.parse = parse

    def __set_name__(self, owner, name: str) -> None:
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        override = obj._overrides.get(self.name, _UNSET)
        if override is not _UNSET:
            return override
        raw = os.environ._data.get(self.key)
        if not raw:
            return self.default
        return self.parse(os.environ.decodevalue(raw))

    def __set__(self, obj, value) -> None:
        obj._overrides[self.name] = value

    def __delete__(self, obj) -> None:
        obj._overrides.pop(self.name, None)


class Settings:
    """See the module docstring for the knob table."""

    noise_stream: str = _Knob("PVW_TPU_NOISE", "kernel")
    noise_value_mac: bool = _Knob("PVW_TPU_NOISE_VALS", True, _parse_bool)
    decode_mode: str = _Knob("PVW_TPU_DECODE", "auto")
    decode_crossover: int = _Knob("PVW_TPU_DECODE_CROSSOVER", 64, int)
    no_native: bool = _Knob("PVW_TPU_NO_NATIVE", False, _parse_bool)
    fused_prescale: str = _Knob("PVW_TPU_FUSED_PRESCALE", "auto")
    swapped_form: bool = _Knob("PVW_TPU_SWAPPED", False, _parse_bool)
    pipeline_fold: bool = _Knob("PVW_TPU_PIPELINE", False, _parse_bool)
    num_digits: Optional[int] = _Knob("PVW_NUM_DIGITS", None, int)
    trace: bool = _Knob("PVW_TPU_TRACE", False, _parse_bool)

    def __init__(self) -> None:
        self._overrides: dict = {}

    def reset(self) -> None:
        """Drop every programmatic override (env vars apply again)."""
        self._overrides.clear()

    def describe(self) -> dict:
        """Current resolved value of every knob."""
        return {
            name: getattr(self, name)
            for name, attr in type(self).__dict__.items()
            if isinstance(attr, _Knob)
        }

    def kernel_noise_stream(self) -> Optional[str]:
        """``"v4"`` for ``"kernel"``/``"v4"``, ``"v3k"`` for the
        global-counter stream, None for ``"v3"``, as in the JAX package.
        v4 is the TPU hardware PRNG, which only a TPU has: its in-kernel
        generation is never available here, so encryption draws v3 planes
        for it, as the JAX package does off the TPU. Unknown values warn
        and take the default."""
        s = str(self.noise_stream).strip().lower()
        if s == "v3":
            return None
        if s == "v3k":
            return "v3k"
        if s not in ("kernel", "v4"):
            warnings.warn(
                f"PVW_TPU_NOISE={self.noise_stream!r} is not a recognized "
                "stream (kernel/v4/v3k/v3); using the default 'kernel'",
                stacklevel=2,
            )
        return "v4"

    def use_fused_prescale(self, num_digits: int) -> bool:
        """The JAX package's choice of the one-pass NTT + prescale kernel
        for the r-stage, kept for parity of the setting; the port has one
        r-stage route. The JAX package's rule: ``auto`` means deep chains only
        (``num_digits >= 8``); booleans and the truthy/falsy strings force
        the choice; an unknown string warns and means ``auto``."""
        mode = self.fused_prescale
        if isinstance(mode, bool):
            return mode
        norm = str(mode).strip().lower()
        if norm in ("1", "true", "on", "yes", "force"):
            return True
        if norm in _FALSY:
            return False
        if norm != "auto":
            warnings.warn(
                f"PVW_TPU_FUSED_PRESCALE={mode!r} is not a recognized mode "
                "(auto/1/0/true/false/on/off); using 'auto'",
                stacklevel=2,
            )
        return num_digits >= 8

    def resolved_decode_mode(self) -> str:
        """The decode mode, one of ``auto``, ``device``, ``host``,
        ``native`` and ``python``; ValueError for anything else."""
        mode = str(self.decode_mode).strip().lower()
        if mode in _DECODE_MODES:
            return mode
        raise ValueError(
            f"PVW_TPU_DECODE={self.decode_mode!r} is not a decode mode "
            f"({'/'.join(_DECODE_MODES)})"
        )

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self.describe().items())
        return f"Settings({body})"


settings = Settings()
