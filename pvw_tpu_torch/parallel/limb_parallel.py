"""RNS limb-parallel encryption and decryption across devices.

The counterpart of ``pvw_tpu.parallel.limb_parallel``. Every quantity of
the scheme is independent limb by limb (c1/c2 limb i is a function of the
operands' limb i, and the randomness is drawn in coefficient space before
it is embedded per limb), so each device runs the single-device encryption
over its block of limbs with limb-restricted parameters
(:meth:`~pvw_tpu_torch.params.PvwParameters.restrict_limbs`: the full-q
gadget and Δ, the sub-ring's tables) and no collectives; concatenating the
limb axes gives the single-device ciphertext bit for bit. Decryption runs
the inner product per limb shard, then concatenates the limb residues on
the first shard's device and decodes there (the decode's CRT lifts need
every limb).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import settings
from ..crypto.decryption import _decode_batch, _noisy_messages
from ..crypto.encryption import PvwCiphertext, _encrypt_kernel, _host_noise_pairs
from ..errors import InvalidParameters
from ..keys.public_key import GlobalPublicKey
from ..keys.secret_key import SecretKey
from ..ops import u64 as u64op
from ..params.parameters import PvwParameters
from ..poly import Poly, Representation
from .sharding import _check_batch, cuda_devices


def limb_partition(num_limbs: int, num_shards: int) -> list[tuple[int, ...]]:
    """Contiguous, balanced limb blocks (larger blocks first)."""
    if not 1 <= num_shards <= num_limbs:
        raise InvalidParameters(
            f"need 1 <= shards <= limbs, got {num_shards} > {num_limbs}")
    base, extra = divmod(num_limbs, num_shards)
    out, start = [], 0
    for s in range(num_shards):
        size = base + (1 if s < extra else 0)
        out.append(tuple(range(start, start + size)))
        start += size
    return out


def _limb_slice(idx) -> slice:
    return slice(idx[0], idx[-1] + 1)


class LimbShardedCiphertext:
    """Per-device channel-major ciphertext limb shards, (c1 [L_s, l, k, d],
    c2 [L_s, l, n, d]) each; :meth:`gather` concatenates the limb axes into
    one :class:`PvwCiphertext` on the first shard's device."""

    def __init__(self, shards, partition, params: PvwParameters) -> None:
        self.shards = shards
        self.partition = partition
        self.params = params

    def gather(self) -> PvwCiphertext:
        dev = self.shards[0][0].device
        c1 = torch.cat([s[0].to(dev) for s in self.shards])
        c2 = torch.cat([s[1].to(dev) for s in self.shards])
        ring = self.params.ring
        return PvwCiphertext(Poly.from_channel_major(c1, Representation.Ntt, ring),
                             Poly.from_channel_major(c2, Representation.Ntt, ring),
                             self.params)


def encrypt_batch_limb_parallel(all_scalars, global_pk: GlobalPublicKey, key,
                                devices=None) -> LimbShardedCiphertext:
    """d-batched encryption with the RNS limb axis split across ``devices``
    (default: every visible CUDA device; a device may repeat; at most one
    shard a limb). Bit-identical to :func:`pvw_tpu_torch.crypto.
    encrypt_batch` under the same key."""
    params = global_pk.params
    devices = list(devices if devices is not None else cuda_devices())
    devices = devices[:min(len(devices), params.ring.num_limbs)]
    partition = limb_partition(params.ring.num_limbs, len(devices))
    arr = np.asarray(all_scalars, np.uint64)
    _check_batch(arr, params, global_pk)
    encode32 = int(arr.max(initial=0)) < 1 << 32
    a_dig, b_dig = global_pk.encrypt_operands()
    min_q = min(params.ring.moduli)
    shards = []
    for idx, dev in zip(partition, devices):
        sub = params.restrict_limbs(idx)
        ls = _limb_slice(idx)
        # bounds >= the full ring's min q: the exact host stream, the same
        # integers on every shard (it depends on the key alone)
        he1, he2 = _host_noise_pairs(sub, key, arr.shape[0], dev, min_q=min_q)
        shards.append(_encrypt_kernel(sub, a_dig[ls].to(dev), b_dig[ls].to(dev),
                                      u64op.u64_tensor(arr, dev), key, encode32, he1, he2,
                                      settings.kernel_noise_stream()))
    return LimbShardedCiphertext(shards, partition, params)


def decrypt_party_shares_limb_parallel(ct: LimbShardedCiphertext, secret_key: SecretKey,
                                       party_index: int) -> list[int]:
    """Batched decryption of a limb-sharded ciphertext: the inner product
    and the inverse NTT per limb shard (no collectives), then the limb
    residues concatenated on the first shard's device and decoded there
    (``_decode_batch``'s routing)."""
    params = ct.params
    if not (0 <= party_index < params.n):
        raise InvalidParameters(f"Party index {party_index} exceeds maximum {params.n - 1}")
    zs = []
    for (c1, c2), idx in zip(ct.shards, ct.partition):
        sk = secret_key.to_polynomials(c1.device).res[:, _limb_slice(idx)]
        zs.append(_noisy_messages(params.restrict_limbs(idx), sk, c1, c2[:, :, party_index]))
    dev0 = zs[0].device
    return _decode_batch(torch.cat([z.to(dev0) for z in zs], dim=1), params)
