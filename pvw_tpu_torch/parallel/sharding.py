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

kdim > 1 shards place the noise and the encode on exactly their row block
of the partial sum, so that the sum holds them once: under stream v3k with
kernel 1's masked form (6-word seeds, noise and encode only on the global
rows [lo, hi)), otherwise by adding them to the block before the gather
("the bake route", the residues made in plain torch). Bounds >= the
smallest modulus take the exact host noise, added after the gather.
Decryption decodes each recv shard's dealers on that shard's device (the
decode is per dealer, so it needs no collective), as the JAX package does
inside its ``shard_map``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import settings
from ..crypto.decryption import _decode_batch
from ..crypto.encryption import (PvwCiphertext, _encode_channel_major,
                                 _host_noise_pairs)
from ..errors import InvalidParameters
from ..keys.public_key import GlobalPublicKey
from ..ops import modmat, ntt as ntt_ops, tfry, u64 as u64op
from ..ops.fused_modmat import (encode_tab, kernel_noise_available, matmul_fold_scaled,
                                ntt_prescale_band, residue_noise_ch)
from ..params.parameters import PvwParameters
from ..poly import Poly, Representation
from ..random import split
from ..sampling.cbd import cbd_bound, sample_vec_cbd_rows
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


def gen_noise_seeds(key, bound: int, row_off: int, stream: str | None, device,
                    mask=None):
    """``gen_noise`` = (seeds, jr, bound, "tfry") of one sharded product
    under stream v3k, or None (no generated noise: another stream, or a
    bound without signed digits), the counterpart of the JAX package's
    ``gen_noise_seeds_v4``. Seeds are (key0, key1, row_off, col_off = 0)
    with the shard's global row offset, or with ``mask`` = (lo, hi) the
    masked form's (key0, key1, row_off, lo, hi, 0). Stream v4 is the TPU's
    hardware PRNG: ``kernel_noise_available`` is False for it, so it draws
    v3 planes here as in the single-device encryption."""
    bound = int(bound)
    if stream != "v3k" or not kernel_noise_available(bound, tfry=True, device=device):
        return None
    k0, k1 = tfry.key_words(key)
    words = (k0, k1, row_off, *(() if mask is None else mask), 0)
    return (words, ntt_ops.signed_digit_count(bound), bound, "tfry")


def _modsum_gathered(parts: list, ring, device):
    """The partials of one axis (limb axis leading) moved to ``device`` and
    added mod q, in axis order."""
    acc = parts[0].to(device)
    q = ring.table("q", device).reshape((-1,) + (1,) * (acc.ndim - 1))
    for p in parts[1:]:
        acc = u64op.addmod(acc, p.to(device), q)
    return acc


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


def _shard_products(params: PvwParameters, a_dig, b_dig, sc, key, my_r: int, my_k: int,
                    kd: int, nl: int, host_e1, host_e2, force_masked: bool,
                    stream: str | None, encode32: bool, device):
    """One shard's partial c1 [L, l, k, d] (None off recv row 0) and c2
    [L, l, nl(+pad), d] (the JAX package's ``shard_fn`` up to its gathers):
    its k block of r through kernel 4, then the products, with the noise and
    the encode on its row block (masked form or bake route) where kd > 1."""
    ring, k, l = params.ring, params.k, params.l
    d = sc.shape[0]
    kc = k // kd
    k_r, k_e1, k_e2 = split(key.to(device), 3)
    var = params.secret_variance
    # r: this shard's k block, rows keyed by global row (cbd-k under v3k)
    if stream == "v3k":
        r = tfry.v3k_cbd_values(*tfry.key_words(k_r), my_k * kc, kc, d, l, var,
                                device=device)
    else:
        r = sample_vec_cbd_rows(k_r, my_k * kc, kc, (d, l), var, device)
    r_op = ntt_prescale_band(r, ring, cbd_bound(var))
    whole_k = kd == 1
    b1, b2 = params.error_bound_1, params.error_bound_2

    # v3 and v4 draw v3 planes at whole k (v3k generates, or has no planes)
    v3_planes = stream != "v3k" and whole_k
    # c1 over the local k block, on recv row 0 only (every row's would be
    # the same); e1 masked to the k-row block at kd > 1
    c1p = None
    if my_r == 0:
        g1 = n1 = None
        if host_e1 is None:
            g1 = gen_noise_seeds(k_e1, b1, 0, stream, device,
                                 None if whole_k and not force_masked
                                 else (my_k * kc, my_k * kc + kc))
            n1 = ntt_ops.noise_digit_planes(k_e1, 0, k, d, l, b1, device) if v3_planes else None
        c1p = matmul_fold_scaled(None, r_op, ring, noise=n1, gen_noise=g1, lhs_dig=a_dig,
                                 noise_bound=b1)
        if host_e1 is None and g1 is None and n1 is None and not whole_k:
            c1p = _bake_rows(c1p, _noise_ntt(params, k_e1, my_k * kc, kc, d, b1, stream,
                                             device), my_k * kc, kc, ring)

    # c2: the local receiver rows; at kd > 1 rc = ceil(nl / kd) rows a block
    glob0 = my_r * nl
    rc = -(-nl // kd)
    blk_lo = my_k * rc
    g2 = None
    if host_e2 is None:
        g2 = gen_noise_seeds(k_e2, b2, glob0, stream, device,
                             None if whole_k and not force_masked
                             else (glob0 + blk_lo, glob0 + blk_lo + rc))
    n2 = (ntt_ops.noise_digit_planes(k_e2, glob0, nl, d, l, b2, device)
          if host_e2 is None and v3_planes else None)
    etab = u64op.u64_tensor(encode_tab(params.gadget_ntt, params.gadget_ntt_shoup,
                                       params.gadget_wrap), device)
    encode = (sc.t().contiguous(), etab) if whole_k or g2 is not None else None
    c2p = matmul_fold_scaled(None, r_op, ring, noise=n2, gen_noise=g2, encode=encode,
                             lhs_dig=b_dig, encode32=encode32, noise_bound=b2)
    if not whole_k and g2 is None:
        # bake route: pad the partial to rc * kd rows (the tail block may
        # reach past nl: its rows carry values sliced off after the gather)
        pad = rc * kd - nl
        sc_p = sc
        if pad:
            c2p = torch.nn.functional.pad(c2p, (0, 0, 0, pad))
            sc_p = torch.nn.functional.pad(sc, (0, pad))
        if host_e2 is None:
            c2p = _bake_rows(c2p, _noise_ntt(params, k_e2, glob0 + blk_lo, rc, d, b2, stream,
                                             device), blk_lo, rc, ring)
        c2p = _bake_rows(c2p, _encode_channel_major(params, sc_p[:, blk_lo:blk_lo + rc]),
                         blk_lo, rc, ring)
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


def _finish_row(params: PvwParameters, key, my_r: int, nl: int, d: int, kd: int,
                c1_parts, c2_parts: list, head, host_e1, host_e2, stream: str | None):
    """Recv row ``my_r``'s gathered partials (kdim order) added mod q on
    ``head``, with the noise that joins after the gather (host noise for
    bounds >= min q; residue noise at kdim = 1): c1 [L, l, k, d] on row 0
    (else None) and the row's c2 [L, l, nl, d]."""
    ring, k = params.ring, params.k
    q = ring.table("q", head).reshape(-1, 1, 1, 1)
    _, k_e1, k_e2 = split(key.to(head), 3)
    b1, b2 = params.error_bound_1, params.error_bound_2
    c1 = None
    if my_r == 0:
        c1 = _modsum_gathered(c1_parts, ring, head)
        if host_e1 is not None:
            c1 = u64op.addmod(c1, host_e1.to(head), q)
        elif kd == 1 and not ntt_ops.signed_digit_count(b1):
            c1 = u64op.addmod(c1, _noise_ntt(params, k_e1, 0, k, d, b1, stream, head), q)
    c2 = _modsum_gathered(c2_parts, ring, head)[:, :, :nl]
    glob0 = my_r * nl
    if host_e2 is not None:
        c2 = u64op.addmod(c2, host_e2[:, :, glob0:glob0 + nl].to(head), q)
    elif kd == 1 and not ntt_ops.signed_digit_count(b2):
        c2 = u64op.addmod(c2, _noise_ntt(params, k_e2, glob0, nl, d, b2, stream, head), q)
    return c1, c2


def _encrypt_kernel_sharded(params: PvwParameters, mesh: Mesh, a_dig, b_dig, sc, key,
                            host_e1=None, host_e2=None, force_masked: bool = False,
                            stream: str | None = "v4", encode32: bool = False):
    """The sharded counterpart of :func:`~pvw_tpu_torch.crypto.encryption.
    _encrypt_kernel`: a_dig int8 [L, l, k, k*nd] and b_dig [L, l, n, k*nd]
    (the cached key planes, cut here into each shard's k-column block and,
    for B, its receiver rows), sc int64 [d, n], ``host_e1``/``host_e2``
    channel-major host noise [L, l, k|n, d] for bounds >= min q, added after
    the gather. ``force_masked`` takes the masked form at kdim = 1 too (its
    range the shard's whole block: the same bytes). c1 is the same on every
    recv row (``shard_map`` computes it on each, replicated); here only
    recv row 0's shards compute their partials. Returns channel-major c1
    [L, l, k, d] and c2 [L, l, n, d] on the mesh's first device."""
    ring, k, n = params.ring, params.k, params.n
    nd = ring.num_digits
    d = sc.shape[0]
    nr, kd = mesh.shape["recv"], mesh.shape["kdim"]
    nl, kc = n // nr, k // kd
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
        row_c1, c2 = _finish_row(params, key, my_r, nl, d, kd, c1_parts, c2_parts,
                                 mesh.devices[my_r][0], host_e1, host_e2, stream)
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


def _decrypt_partial(ring, sk, c1_ch, ks: slice, dls: slice, device):
    """One shard's partial <s, c1_d> over its k block ``ks`` for its
    dealers ``dls``: sk NTT residues [k, L, l], c1_ch [L, l, k, d] ->
    [L, l, dl] on ``device``."""
    skc = sk[ks].to(device).permute(1, 2, 0)[:, :, None, :]               # [L, l, 1, kc]
    return modmat.matmul_channels(skc, c1_ch[:, :, ks, dls].to(device), ring)[:, :, 0]


def _decrypt_finish(ring, parts: list, c2_rows, head):
    """A recv row's gathered partials (kdim order) added mod q on ``head``,
    minus its dealers' c2 [L, l, dl], through the inverse NTT: PowerBasis
    residues int64 [dl, L, l]."""
    s = _modsum_gathered(parts, ring, head)
    q = ring.table("q", head)[:, None, None]
    z = u64op.submod(s, c2_rows.to(head), q).permute(2, 0, 1)             # [dl, L, l]
    return ntt_ops.ntt_inverse(z, ring)


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
        parts = [_decrypt_partial(ring, sk, c1_ch, slice(my_k * kc, (my_k + 1) * kc), dls,
                                  mesh.devices[my_r][my_k]) for my_k in range(kd)]
        out.append(_decrypt_finish(ring, parts, c2_ch[:, :, dls], mesh.devices[my_r][0]))
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
