"""Sharded PVW encryption and decryption over a (recv, kdim) device mesh.

The counterpart of ``pvw_tpu.parallel.sharding``. A :class:`Mesh` is a
2-D grid of ``torch.device``s with the axes

- ``recv``: the n receivers, so B's rows, c2's rows and each receiver's
  encode and e2 noise live on the shard that owns them;
- ``kdim``: the k contraction of ``A·r`` and ``B·r``: each shard holds a
  k/kdim block of the contraction and computes a partial product; the
  partials meet on the axis' first device and are added mod q there (a
  plain sum would leave the residues unreduced).

The JAX package runs the shard program under ``shard_map``, one program
on every device at once. Here it runs shard by shard in one process, on
each shard's device; a device may repeat in the mesh (``cuda:0`` four times
gives a (2, 2) mesh on one card, the CPU device repeated is the
counterpart of the JAX tests' virtual CPU devices). Every random stream is
counter-based and keyed by global row and column, so each shard draws the
values the single-device encryption places in its block, and the sharded
ciphertext is bit-identical to it on any mesh shape.

Each stage is the single device's: a shard draws its k block of r with
:func:`~pvw_tpu_torch.crypto.encryption._r_operand`, and a shard that holds
the whole k runs :func:`~pvw_tpu_torch.crypto.encryption._product` for c1
and c2 as the single device does (the same noise routes, the residue noise
in kernel 1's ``post=``). kdim > 1 shards place the noise and the encode
on exactly their row block of the partial sum, so that the sum holds them
once: under stream v3k with ``_product``'s masked form (6-word seeds,
noise and encode only on the global rows [lo, hi)), otherwise by adding
them to the block before the gather ("the bake route", the residues made
in plain torch); there bounds >= the smallest modulus take the exact host
noise after the gather. Decryption contracts each shard's k block with
:func:`~pvw_tpu_torch.crypto.decryption._contraction` and finishes each
recv row with ``_noisy_finish``, and decodes each recv shard's dealers on that shard's device (the
decode is per dealer, so it needs no collective), as the JAX package does
inside its ``shard_map``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import settings
from ..crypto.decryption import _contraction, _decode_batch, _noisy_finish
from ..crypto.encryption import (PvwCiphertext, _encode_channel_major, _encode_table,
                                 _gen_noise, _host_noise_pairs, _product, _r_operand)
from ..errors import InvalidParameters
from ..keys.public_key import GlobalPublicKey
from ..ops import ntt as ntt_ops, tfry, u64 as u64op
from ..ops.fused_modmat import matmul_fold_scaled, residue_noise_ch
from ..params.parameters import PvwParameters
from ..poly import Poly, Representation
from ..random import split
from ..sampling.uniform import sample_uniform_signed_rows


class Mesh:
    """A 2-D grid of devices with the axes ``("recv", "kdim")``;
    ``devices[r][j]`` is the shard at recv index r, kdim index j, and
    ``shape`` maps each axis to its size, as ``jax.sharding.Mesh`` does."""

    axis_names = ("recv", "kdim")

    def __init__(self, devices) -> None:
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise InvalidParameters("a mesh needs a non-empty rectangular grid of devices")
        self.devices = rows
        self.shape = {"recv": len(rows), "kdim": len(rows[0])}

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={self.devices})"


def cuda_devices() -> list:
    """Every visible CUDA device; raises when there is none (the port never
    falls back to the CPU on its own: pass the CPU devices explicitly)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("pvw_tpu_torch.parallel: no CUDA device is visible; pass "
                           "devices=[torch.device('cpu')] * n to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None, kdim: int | None = None) -> Mesh:
    """A (recv, kdim) mesh over ``devices`` (default: every visible CUDA
    device; a device may repeat). ``kdim`` defaults to 2 for an even count
    of at least 2 devices, else 1."""
    devices = list(devices if devices is not None else cuda_devices())
    n = len(devices)
    if kdim is None:
        kdim = 2 if n % 2 == 0 and n >= 2 else 1
    if kdim < 1 or n % kdim:
        raise InvalidParameters(f"{n} devices not divisible by kdim={kdim}")
    return Mesh([devices[r * kdim:(r + 1) * kdim] for r in range(n // kdim)])


def _modsum_gathered(parts: list, ring, device):
    """The partials of one axis (limb axis leading) moved to ``device`` and
    added mod q, in axis order."""
    acc = parts[0].to(device)
    q = ring.table("q", device).reshape((-1,) + (1,) * (acc.ndim - 1))
    for p in parts[1:]:
        acc = u64op.addmod(acc, p.to(device), q)
    return acc


def _plain(name: str, fn):
    """The shards' default stage hook: the step alone, in no span of its own."""
    return fn()


def _noise_ntt(params: PvwParameters, kk, row_off: int, rows: int, d: int, bound: int,
               stream: str | None, device):
    """Row-keyed noise of global rows [row_off, row_off + rows) as NTT
    residues, channel-major [L, l, rows, d]: the values the single-device
    draw places there (v3k values, v3 signed rows, or
    :func:`residue_noise_ch` for bounds above the signed-digit range)."""
    ring, l = params.ring, params.l
    if ntt_ops.signed_digit_count(bound):
        if stream == "v3k":
            ec = tfry.v3k_values(*tfry.key_words(kk), row_off, rows, d, l, bound,
                                 device=device)
        else:
            ec = sample_uniform_signed_rows(kk, row_off, rows, (d, l), bound, device)
        return ntt_ops.ntt_forward_signed_ch(ec, ring, bound)
    return residue_noise_ch(kk, row_off, rows, d, bound, ring, device)


def _bake_rows(part, block, row0: int, rows: int, ring):
    """``block`` [L, l, rows, d] added mod q into rows [row0, row0 + rows) of
    a partial [L, l, m, d] before the kdim gather, in place (the partial is
    the shard's own), so that the sum holds it once (modular adds commute:
    the same residues as adding it after)."""
    q = ring.table("q", part.device).reshape(-1, 1, 1, 1)
    part[:, :, row0:row0 + rows] = u64op.addmod(part[:, :, row0:row0 + rows], block, q)
    return part


def _shard_product(params: PvwParameters, r_op, lhs_dig, kk, rows: int, row_off: int,
                   bound: int, host_e, sc, encode32: bool, kd: int, my_k: int,
                   force_masked: bool, stream: str | None, device, stage=_plain):
    """One shard's partial of a product over the global rows [row_off,
    row_off + rows), with the encode of ``sc`` [d, rows] (c2's; None for
    c1's). At whole k (kd = 1) it is :func:`_product`, as on a single
    device (``force_masked``: its masked form over the whole block; the host
    noise ``host_e`` of the rows added in it). At kd > 1 the noise and the
    encode land on the shard's block of ceil(rows / kd) rows, so that the
    sum holds them once: by :func:`_product`'s masked form where the v3k
    generator draws the noise, else by the bake route (a bare product padded
    to kd blocks, the block's noise and encode added in plain torch; the
    tail block may reach past the rows, sliced off after the gather); host
    noise then joins after the gather (:func:`_finish_row`). ``stage(name,
    fn)`` runs the steps: "products" (kernel 1, with whatever
    :func:`_product` draws for it), then on the bake route "bake"."""
    blk = -(-rows // kd)
    lo = my_k * blk
    mask = None if kd == 1 and not force_masked else (row_off + lo, row_off + lo + blk)
    if kd == 1 or (host_e is None and _gen_noise(kk, bound, stream, device, row_off,
                                                 mask=mask) is not None):
        encode = None if sc is None else (sc.t().contiguous(), _encode_table(params, device))
        return stage("products", lambda: _product(
            params, r_op, lhs_dig, kk, rows, bound, stream,
            None if kd > 1 or host_e is None else host_e.to(device), encode, encode32,
            row_off=row_off, mask=mask))
    ring = params.ring
    part = stage("products", lambda: matmul_fold_scaled(None, r_op, ring, lhs_dig=lhs_dig))

    def bake(part):
        pad = blk * kd - rows
        if pad:
            part = torch.nn.functional.pad(part, (0, 0, 0, pad))
        if host_e is None:
            part = _bake_rows(part, _noise_ntt(params, kk, row_off + lo, blk, r_op.shape[-1],
                                               bound, stream, device), lo, blk, ring)
        if sc is not None:
            sc_p = torch.nn.functional.pad(sc, (0, pad)) if pad else sc
            part = _bake_rows(part, _encode_channel_major(params, sc_p[:, lo:lo + blk]), lo,
                              blk, ring)
        return part

    return stage("bake", lambda: bake(part))


def _shard_products(params: PvwParameters, a_dig, b_dig, sc, key, my_r: int, my_k: int,
                    kd: int, nl: int, host_e1, host_e2, force_masked: bool,
                    stream: str | None, encode32: bool, device, stage=_plain):
    """One shard's partial c1 [L, l, k, d] (None off recv row 0) and c2
    [L, l, nl(+pad), d] (the JAX package's ``shard_fn`` up to its gathers):
    its k block of r (:func:`_r_operand`, the step "r_stage" of ``stage``),
    then the products (:func:`_shard_product`)."""
    kc = params.k // kd
    k_r, k_e1, k_e2 = split(key.to(device), 3)
    r_op = stage("r_stage", lambda: _r_operand(params, k_r, (my_k * kc, kc), sc.shape[0],
                                               stream, 0, device))
    # c1 over the local k block, on recv row 0 only (every row's would be the same)
    c1p = None
    if my_r == 0:
        c1p = _shard_product(params, r_op, a_dig, k_e1, params.k, 0, params.error_bound_1,
                             host_e1, None, False, kd, my_k, force_masked, stream, device,
                             stage)
    glob0 = my_r * nl
    c2p = _shard_product(params, r_op, b_dig, k_e2, nl, glob0, params.error_bound_2,
                         None if host_e2 is None else host_e2[:, :, glob0:glob0 + nl], sc,
                         encode32, kd, my_k, force_masked, stream, device, stage)
    return c1p, c2p


def _shard_operands(a_dig, b_dig, sc, my_r: int, my_k: int, nl: int, kc: int, nd: int,
                    device):
    """Shard (my_r, my_k)'s operands on ``device``: A's k-column block (on
    recv row 0 only, else None), B's receiver rows and k-column block, and
    the scalars of its receivers."""
    cols = slice(my_k * kc * nd, (my_k + 1) * kc * nd)
    rows = slice(my_r * nl, (my_r + 1) * nl)
    return (a_dig[:, :, :, cols].to(device).contiguous() if my_r == 0 else None,
            b_dig[:, :, rows, cols].to(device).contiguous(), sc[:, rows].to(device))


def _finish_row(params: PvwParameters, my_r: int, nl: int, kd: int, c1_parts,
                c2_parts: list, head, host_e1, host_e2):
    """Recv row ``my_r``'s gathered partials (kdim order) added mod q on
    ``head``, with the host noise of bounds >= min q where the shards hold
    part of k (at kd = 1 each shard's product has added it): c1
    [L, l, k, d] on row 0 (else None) and the row's c2 [L, l, nl, d]."""
    ring = params.ring
    q = ring.table("q", head).reshape(-1, 1, 1, 1)
    c1 = None
    if my_r == 0:
        c1 = _modsum_gathered(c1_parts, ring, head)
        if host_e1 is not None and kd > 1:
            c1 = u64op.addmod(c1, host_e1.to(head), q)
    c2 = _modsum_gathered(c2_parts, ring, head)[:, :, :nl]
    if host_e2 is not None and kd > 1:
        c2 = u64op.addmod(c2, host_e2[:, :, my_r * nl:(my_r + 1) * nl].to(head), q)
    return c1, c2


def _encrypt_kernel_sharded(params: PvwParameters, mesh: Mesh, a_dig, b_dig, sc, key,
                            host_e1=None, host_e2=None, force_masked: bool = False,
                            stream: str | None = "v4", encode32: bool = False):
    """The sharded counterpart of :func:`~pvw_tpu_torch.crypto.encryption.
    _encrypt_kernel`: a_dig int8 [L, l, k, k*nd] and b_dig [L, l, n, k*nd]
    (the cached key planes, cut here into each shard's k-column block and,
    for B, its receiver rows), sc int64 [d, n], ``host_e1``/``host_e2``
    channel-major host noise [L, l, k|n, d] for bounds >= min q
    (:func:`_shard_product` says where each adds). ``force_masked`` takes
    the masked form at kdim = 1 too (its range the shard's whole block: the
    same bytes). c1 is the same on every
    recv row (``shard_map`` computes it on each, replicated); here only
    recv row 0's shards compute their partials. Returns channel-major c1
    [L, l, k, d] and c2 [L, l, n, d] on the mesh's first device."""
    nd = params.ring.num_digits
    nr, kd = mesh.shape["recv"], mesh.shape["kdim"]
    nl, kc = params.n // nr, params.k // kd
    dev0 = mesh.devices[0][0]
    c1 = None
    c2_rows = []
    for my_r in range(nr):
        c1_parts, c2_parts = [], []
        for my_k in range(kd):
            dev = mesh.devices[my_r][my_k]
            p1, p2 = _shard_products(
                params, *_shard_operands(a_dig, b_dig, sc, my_r, my_k, nl, kc, nd, dev), key,
                my_r, my_k, kd, nl, host_e1, host_e2, force_masked, stream, encode32, dev)
            c1_parts.append(p1)
            c2_parts.append(p2)
        row_c1, c2 = _finish_row(params, my_r, nl, kd, c1_parts, c2_parts,
                                 mesh.devices[my_r][0], host_e1, host_e2)
        if my_r == 0:
            c1 = row_c1
        c2_rows.append(c2.to(dev0))
        del c1_parts, c2_parts
    return c1.to(dev0), torch.cat(c2_rows, dim=2)


def _check_batch(arr, params: PvwParameters, global_pk: GlobalPublicKey) -> None:
    if arr.ndim != 2 or arr.shape[1] != params.n:
        raise InvalidParameters(f"Must provide exactly n={params.n} scalars per row")
    if not global_pk.is_full():
        raise InvalidParameters("Global public key is not complete (missing party keys)")
    if not params.verify_correctness_condition():
        raise InvalidParameters(
            "Parameters do not satisfy correctness condition - decryption may fail")


def encrypt_batch_sharded(all_scalars, global_pk: GlobalPublicKey, key, mesh: Mesh, *,
                          _force_masked: bool = False) -> PvwCiphertext:
    """Mesh-sharded :func:`pvw_tpu_torch.crypto.encrypt_batch`: a batched
    ciphertext (c1 [k, d], c2 [n, d], channel-major on the mesh's first
    device) bit-identical to the single-device one. ``_force_masked``: the
    masked form at kdim = 1 too, so that one card runs the composition a
    kdim > 1 mesh runs."""
    params = global_pk.params
    arr = np.asarray(all_scalars, np.uint64)
    _check_batch(arr, params, global_pk)
    nr, kd = mesh.shape["recv"], mesh.shape["kdim"]
    if params.n % nr or params.k % kd:
        raise InvalidParameters(
            f"n={params.n} must divide over recv={nr} and k={params.k} over kdim={kd}")
    dev0 = mesh.devices[0][0]
    sc = u64op.u64_tensor(arr, dev0)
    a_dig, b_dig = global_pk.encrypt_operands()
    host_e1, host_e2 = _host_noise_pairs(params, key, arr.shape[0], dev0)
    c1, c2 = _encrypt_kernel_sharded(params, mesh, a_dig, b_dig, sc, key, host_e1, host_e2,
                                     _force_masked, settings.kernel_noise_stream(),
                                     int(arr.max(initial=0)) < 1 << 32)
    return PvwCiphertext(Poly.from_channel_major(c1, Representation.Ntt, params.ring),
                         Poly.from_channel_major(c2, Representation.Ntt, params.ring), params)


def _noisy_sharded_ch(params: PvwParameters, mesh: Mesh, sk, c1_ch, c2_ch) -> list:
    """Sharded decryption stage, channel-major: z_d = <s, c1_d> - c2_d with
    the dealers over recv and the k contraction over kdim (gathered and
    added mod q on the axis' first device), then the inverse NTT. sk NTT
    residues [k, L, l]; c1_ch [L, l, k, d]; c2_ch [L, l, d] -> each recv
    row's PowerBasis residues, int64 [d / recv, L, l] on the row's first
    device, in dealer order."""
    ring, k, d = params.ring, params.k, c1_ch.shape[3]
    nr, kd = mesh.shape["recv"], mesh.shape["kdim"]
    if d % nr or k % kd:
        raise InvalidParameters(
            f"dealer batch {d} must divide over recv={nr} and k={k} over kdim={kd}")
    dl, kc = d // nr, k // kd
    out = []
    for my_r in range(nr):
        dls = slice(my_r * dl, (my_r + 1) * dl)
        parts = []
        for my_k in range(kd):
            ks, dev = slice(my_k * kc, (my_k + 1) * kc), mesh.devices[my_r][my_k]
            parts.append(_contraction(ring, sk[ks].to(dev), c1_ch[:, :, ks, dls].to(dev)))
        head = mesh.devices[my_r][0]
        out.append(_noisy_finish(ring, _modsum_gathered(parts, ring, head), c2_ch[:, :, dls]))
    return out


def _noisy_sharded(params: PvwParameters, mesh: Mesh, sk, c1, c2) -> list:
    """:func:`_noisy_sharded_ch` of canonical c1 [k, d, L, l] and c2
    [d, L, l] (the channel-major views of the same tensors)."""
    return _noisy_sharded_ch(params, mesh, sk, c1.permute(2, 3, 0, 1), c2.permute(1, 2, 0))


def decrypt_party_shares_sharded(ct: PvwCiphertext, secret_key, party_index: int,
                                 mesh: Mesh) -> list[int]:
    """Mesh-sharded ``decrypt_party_shares`` of a batched ciphertext: the
    dealers over ``recv``, the k contraction over ``kdim``, channel-major
    or canonical. Each recv row's dealers decode on the row's first device
    (``_decode_batch``'s routing with no batch size, as in the JAX
    package's backends: the device decode by default, the C++ engine under
    ``host`` and ``native`` or where the device decode does not cover the
    parameters, the Python decode under ``python``)."""
    params = ct.params
    if len(ct.c1.batch_shape) != 2:
        raise InvalidParameters("expected a batched ciphertext")
    sk = secret_key.to_polynomials(mesh.devices[0][0]).res
    if ct.c1.is_channel_major and ct.c2.is_channel_major:
        rows = _noisy_sharded_ch(params, mesh, sk, ct.c1.channel(),
                                 ct.c2.channel()[:, :, party_index])
    else:
        rows = _noisy_sharded(params, mesh, sk, ct.c1.res, ct.c2.res[party_index])
    return [m for z in rows for m in _decode_batch(z, params)]
