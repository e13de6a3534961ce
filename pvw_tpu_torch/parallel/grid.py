"""Grid parallelism: RNS limb groups (outer, no collectives) x the
(recv, kdim) mesh (inner).

The counterpart of ``pvw_tpu.parallel.grid``. The devices split into
``limb_groups`` equal subsets; each runs the mesh-sharded encryption
(:mod:`pvw_tpu_torch.parallel.sharding`) over its block of limbs with
limb-restricted parameters, and the limb axes concatenate to the
single-device ciphertext bit for bit. Collectives stay inside each group's
mesh. Decryption gathers each dealer block's limb residues onto the first
group's device for that block and decodes there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import settings
from ..crypto.decryption import _decode_batch
from ..crypto.encryption import PvwCiphertext, _host_noise_pairs
from ..errors import InvalidParameters
from ..keys.public_key import GlobalPublicKey
from ..keys.secret_key import SecretKey
from ..ops import u64 as u64op
from ..params.parameters import PvwParameters
from ..poly import Poly, Representation
from .limb_parallel import _limb_slice, limb_partition
from .sharding import (_check_batch, _encrypt_kernel_sharded, _noisy_sharded_ch,
                       cuda_devices, make_mesh)


class GridShardedCiphertext:
    """Per-limb-group channel-major ciphertext shards, (c1 [L_g, l, k, d],
    c2 [L_g, l, n, d]) each on its group mesh's first device, with the
    groups' meshes; :meth:`gather` concatenates the limb axes into one
    :class:`PvwCiphertext` on the first group's device."""

    def __init__(self, shards, partition, meshes, params: PvwParameters) -> None:
        self.shards = shards
        self.partition = partition
        self.meshes = meshes
        self.params = params

    def gather(self) -> PvwCiphertext:
        dev = self.shards[0][0].device
        c1 = torch.cat([s[0].to(dev) for s in self.shards])
        c2 = torch.cat([s[1].to(dev) for s in self.shards])
        ring = self.params.ring
        return PvwCiphertext(Poly.from_channel_major(c1, Representation.Ntt, ring),
                             Poly.from_channel_major(c2, Representation.Ntt, ring),
                             self.params)


def _device_groups(devices, limb_groups: int):
    if len(devices) % limb_groups:
        raise InvalidParameters(
            f"{len(devices)} devices not divisible into {limb_groups} limb groups")
    per = len(devices) // limb_groups
    return [devices[g * per:(g + 1) * per] for g in range(limb_groups)]


def encrypt_batch_grid(all_scalars, global_pk: GlobalPublicKey, key, devices=None,
                       limb_groups: int = 2, kdim: int | None = None) -> GridShardedCiphertext:
    """d-batched encryption over the (limb x recv x kdim) grid of
    ``devices`` (default: every visible CUDA device; a device may repeat),
    bit-identical to :func:`pvw_tpu_torch.crypto.encrypt_batch` under the
    same key. Each limb group runs on its own (recv, kdim) mesh."""
    params = global_pk.params
    devices = list(devices if devices is not None else cuda_devices())
    if not 1 <= limb_groups <= params.ring.num_limbs:
        raise InvalidParameters(f"need 1 <= limb_groups <= {params.ring.num_limbs}")
    groups = _device_groups(devices, limb_groups)
    partition = limb_partition(params.ring.num_limbs, limb_groups)
    arr = np.asarray(all_scalars, np.uint64)
    _check_batch(arr, params, global_pk)
    encode32 = int(arr.max(initial=0)) < 1 << 32
    a_dig, b_dig = global_pk.encrypt_operands()
    min_q = min(params.ring.moduli)
    shards, meshes = [], []
    for idx, devs in zip(partition, groups):
        sub = params.restrict_limbs(idx)
        ls = _limb_slice(idx)
        mesh = make_mesh(devs, kdim=kdim)
        nr, kd = mesh.shape["recv"], mesh.shape["kdim"]
        if params.n % nr or params.k % kd:
            raise InvalidParameters(f"n={params.n} must divide over recv={nr} and "
                                    f"k={params.k} over kdim={kd}")
        dev0 = mesh.devices[0][0]
        # bounds >= the full ring's min q: the same host integers in every group
        he1, he2 = _host_noise_pairs(sub, key, arr.shape[0], dev0, min_q=min_q)
        shards.append(_encrypt_kernel_sharded(
            sub, mesh, a_dig[ls], b_dig[ls], u64op.u64_tensor(arr, dev0), key, he1, he2,
            False, settings.kernel_noise_stream(), encode32))
        meshes.append(mesh)
    return GridShardedCiphertext(shards, partition, meshes, params)


def decrypt_party_shares_grid(ct: GridShardedCiphertext, secret_key: SecretKey,
                              party_index: int) -> list[int]:
    """Batched decryption over the grid: each limb group runs the
    mesh-sharded inner product (dealers over recv, the contraction over
    kdim); then each recv row's dealer block gathers its limb residues onto
    the first group's device for that row and decodes there (the CRT lifts
    need every limb; ``_decode_batch``'s routing)."""
    params = ct.params
    if not (0 <= party_index < params.n):
        raise InvalidParameters(f"Party index {party_index} exceeds maximum {params.n - 1}")
    groups = []
    for (c1, c2), idx, mesh in zip(ct.shards, ct.partition, ct.meshes):
        sk = secret_key.to_polynomials(mesh.devices[0][0]).res[:, _limb_slice(idx)]
        groups.append(_noisy_sharded_ch(params.restrict_limbs(idx), mesh, sk, c1,
                                        c2[:, :, party_index]))
    out = []
    for rows in zip(*groups):                      # one dealer block, every limb group
        dev = rows[0].device
        out += _decode_batch(torch.cat([z.to(dev) for z in rows], dim=1), params)
    return out
