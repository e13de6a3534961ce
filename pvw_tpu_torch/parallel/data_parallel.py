"""Dealer-batch data-parallel encryption: the dealer axis split across
devices.

The counterpart of ``pvw_tpu.parallel.data_parallel``. Each device encrypts
its own block of dealer columns with the unmodified single-device
encryption (:func:`~pvw_tpu_torch.crypto.encryption._encrypt_kernel`): no
collectives, B replicated. Under ``noise_stream="v3k"`` with both error
bounds in the signed-digit range the shard outputs concatenate to exactly
the single-device ciphertext: the v3k counters are global (row, column,
coefficient) coordinates and each shard passes its global dealer-column
offset. Every other configuration takes an independent key per shard,
``fold_in(key, 1_000_003 + idx)``: the other streams ignore the column
offset, and one key for every shard would reuse the randomness r across
shards (two dealers at the same local column would differ by the encode of
their message difference and noise alone). Bounds >= the smallest modulus
(the host stream is sequential over the whole batch) are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import settings
from ..crypto.encryption import PvwCiphertext, _encrypt_kernel
from ..errors import InvalidParameters
from ..keys.public_key import GlobalPublicKey
from ..ops import u64 as u64op
from ..ops.ntt import signed_digit_count
from ..poly import Poly, Representation
from ..random import fold_in
from .sharding import _check_batch, cuda_devices


class DealerShardedCiphertext:
    """Per-device dealer-block ciphertexts; :meth:`gather` concatenates them
    into one batched :class:`PvwCiphertext` (c1 [k, d], c2 [n, d]) on the
    first shard's device."""

    def __init__(self, shards, offsets, params) -> None:
        self.shards = shards            # [(c1, c2)] channel-major, per device
        self.offsets = offsets          # global dealer offset of each shard
        self.params = params

    def gather(self) -> PvwCiphertext:
        dev = self.shards[0][0].device
        c1 = torch.cat([s[0].to(dev) for s in self.shards], dim=3)
        c2 = torch.cat([s[1].to(dev) for s in self.shards], dim=3)
        ring = self.params.ring
        return PvwCiphertext(Poly.from_channel_major(c1, Representation.Ntt, ring),
                             Poly.from_channel_major(c2, Representation.Ntt, ring),
                             self.params)


def encrypt_batch_data_parallel(all_scalars, global_pk: GlobalPublicKey, key,
                                devices=None) -> DealerShardedCiphertext:
    """d-batched encryption with the dealer axis split across ``devices``
    (default: every visible CUDA device; a device may repeat), a balanced
    block of dealers each (the ragged tail allowed). Bit-identical to
    :func:`pvw_tpu_torch.crypto.encrypt_batch` under ``noise_stream="v3k"``
    with both bounds in the signed-digit range."""
    params = global_pk.params
    devices = list(devices if devices is not None else cuda_devices())
    arr = np.asarray(all_scalars, np.uint64)
    _check_batch(arr, params, global_pk)
    d = arr.shape[0]
    nshards = min(len(devices), d)
    if max(params.error_bound_1, params.error_bound_2) >= min(params.ring.moduli):
        raise InvalidParameters(
            "data-parallel encryption does not support error bounds >= the smallest "
            "modulus (the exact host stream is sequential over the full batch); use "
            "encrypt_batch or the mesh backends")
    base, rem = divmod(d, nshards)
    sizes = [base + (1 if i < rem else 0) for i in range(nshards)]
    offsets = [sum(sizes[:i]) for i in range(nshards)]
    encode32 = int(arr.max(initial=0)) < 1 << 32
    a_dig, b_dig = global_pk.encrypt_operands()
    stream = settings.kernel_noise_stream()
    # the exact global-counter contract holds only for v3k with both bounds
    # in the signed-digit range; elsewhere a shared key would reuse r
    exact = (stream == "v3k" and signed_digit_count(params.error_bound_1) > 0
             and signed_digit_count(params.error_bound_2) > 0)
    shards = []
    for idx, (off, sz, dev) in enumerate(zip(offsets, sizes, devices)):
        shard_key = key if exact else fold_in(key, 1_000_003 + idx)
        shards.append(_encrypt_kernel(
            params, a_dig.to(dev), b_dig.to(dev), u64op.u64_tensor(arr[off:off + sz], dev),
            shard_key, encode32, None, None, stream, off if exact else 0))
    return DealerShardedCiphertext(shards, offsets, params)
