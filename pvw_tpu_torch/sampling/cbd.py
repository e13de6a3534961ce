"""Centered binomial sampling from threefry keys.

The counterpart of ``pvw_tpu.sampling.cbd`` (the reference's
``sample_vec_cbd``, ``uniform.rs:27-70``): variance 0.5 gives b1 - b2 of
two bits; integer variance v in [1, 16] gives the popcount of 2v bits
minus the popcount of the next 2v. Every sample comes from an explicit
key, bit-identical to the JAX package for the same key.
"""

from __future__ import annotations

import torch

from ..errors import SamplingError
from ..ops.tfry import cbd_from_words
from ..random import bits, fold_in
from ..utils.device import resolve_device


def _check_variance(variance: float) -> None:
    if not (0.5 <= float(variance) <= 16.0):
        # reference error string: uniform.rs:33
        raise SamplingError("The variance should be between 0.5 and 16")


def sample_vec_cbd(key, shape, variance: float, device="cuda") -> torch.Tensor:
    """int32 tensor of ``shape`` with CBD(variance) samples; ``variance``
    is 0.5 or (truncated, as ``variance as usize``) an integer in [1, 16]."""
    _check_variance(variance)
    words = bits(key, tuple(shape) + (2,), device=resolve_device(device))
    return cbd_from_words(words[..., 0], words[..., 1], variance)


def sample_vec_cbd_rows(key, row_offset: int, num_rows: int, shape_tail,
                        variance: float, device="cuda") -> torch.Tensor:
    """Row-keyed CBD ("stream v2"): row i is drawn from
    ``fold_in(key, row_offset + i)``, so any row block of a larger call
    gives the same values. int32 [num_rows, *shape_tail]."""
    _check_variance(variance)
    dev = resolve_device(device)
    keys = fold_in(key.to(dev), row_offset + torch.arange(num_rows, device=dev))
    words = bits(keys, tuple(shape_tail) + (2,))
    return cbd_from_words(words[..., 0], words[..., 1], variance)


def cbd_bound(variance: float) -> int:
    """Maximum |coefficient| for CBD(variance): 1 at variance 0.5, else 2v."""
    if abs(float(variance) - 0.5) < 1e-6:
        return 1
    return 2 * int(variance)
