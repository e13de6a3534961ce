"""Carry the JAX package's state into the port, from numpy arrays.

Each function takes what a ``pvw_tpu`` accessor returns and builds the
port's object, so both packages can compute from identical state. Only
numpy goes in; nothing here imports ``pvw_tpu``. Extend this module rather
than forking it when a later slice needs another object.

=============================  ==========================================
Function                       Input, and the ``pvw_tpu`` accessor giving it
=============================  ==========================================
``params_from_dict``           ``PvwParameters.to_dict()``
``crs_from_residues``          ``PvwCrs.matrix.residues_np()``, uint64
                               [k, k, L, l]
``global_pk_from_residues``    ``GlobalPublicKey.matrix.residues_np()``,
                               uint64 [n, k, L, l]
``secret_key_from_coeffs``     ``SecretKey.secret_coeffs``, int [k, l]
``key_from_words``             ``jax.random.key_data(key)``, uint32 [2]
=============================  ==========================================
"""

from __future__ import annotations

import numpy as np
import torch

from .keys.public_key import GlobalPublicKey
from .keys.secret_key import SecretKey
from .params.crs import PvwCrs
from .params.parameters import PvwParameters
from .poly import Poly, Representation


def params_from_dict(d: dict) -> PvwParameters:
    """The 7-field dict form of ``PvwParameters.to_dict()``."""
    return PvwParameters.from_dict(d)


def crs_from_residues(residues: np.ndarray, params: PvwParameters,
                      device="cuda") -> PvwCrs:
    """NTT residues uint64 [k, k, L, l] -> PvwCrs."""
    return PvwCrs(Poly.from_residues_np(residues, params.ring, Representation.Ntt,
                                        device=device), params)


def global_pk_from_residues(residues: np.ndarray, crs: PvwCrs) -> GlobalPublicKey:
    """NTT residues uint64 [n, k, L, l] of every key row -> a full
    GlobalPublicKey on the CRS's device."""
    gpk = GlobalPublicKey(crs)
    gpk.matrix = Poly.from_residues_np(residues, crs.params.ring,
                                       Representation.Ntt, device=crs.device)
    gpk.num_keys = gpk.matrix.batch_shape[0]
    gpk.validate()
    return gpk


def secret_key_from_coeffs(coeffs: np.ndarray, params: PvwParameters) -> SecretKey:
    """Secret coefficients int [k, l] -> SecretKey."""
    return SecretKey.from_coefficients(params, coeffs)


def key_from_words(words: np.ndarray) -> torch.Tensor:
    """The two uint32 words of a JAX key -> the port's key tensor."""
    w = np.asarray(words, np.uint32).reshape(2).astype(np.int64)
    return torch.from_numpy(w)
