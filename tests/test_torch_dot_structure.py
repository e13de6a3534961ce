"""The port's dot-structure probe against the JAX package's, on the CPU.

The three TPU kernels of ``benchmarks/probe_dot_structure.py`` are
closures inside its ``main()`` and cannot be imported, so this file
transcribes them: their layouts with ``jnp`` (the band :65, merged along
the lanes :107, interleaved in blocks of TN :141-145) and their bodies in
numpy (``pallas_dots`` :80-86, ``pallas_one_dot`` :109-117,
``pallas_wide_dot`` :148-156, each tile of TN output columns as its grid
step j sees it). The port's layout functions, ``dot_structure_plain`` and
``dot_structure`` (on the CPU the plain version) are held against them at
tn = 8 and 32 and nd = 5 and 8: exact equality. The CUDA kernel is held
against its plain version in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvw_tpu_torch.benchmarks import probe_dot_structure as ds
from pvw_tpu_torch.ops import modmat

CH, M, KD, D = 2, 6, 40, 64


def operands(nd, seed):
    """lhs int8 [CH, m, kd] and a band int8 [CH, nd, kd, D], the whole int8
    range (the JAX probe draws [-64, 64))."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (CH, M, KD)).astype(np.int8),
            rng.integers(-128, 128, (CH, nd, KD, D)).astype(np.int8))


def jax_band_m(band):
    """probe_dot_structure.py:107."""
    ch, nd, kd, d = band.shape
    return np.asarray(jnp.transpose(jnp.asarray(band), (0, 2, 1, 3)).reshape(ch, kd, nd, d))


def jax_band_w(band, tn):
    """probe_dot_structure.py:141-145."""
    ch, nd, kd, d = band.shape
    return np.asarray(jnp.asarray(band).reshape(ch, nd, kd, d // tn, tn)
                      .transpose(0, 2, 3, 1, 4).reshape(ch, kd, (d // tn) * nd * tn))


def combine(planes):
    """acc = p if acc is None else acc + (p >> (c + 1)), int32 wrapping
    (the bodies' epilogue)."""
    acc = None
    for c, p in enumerate(planes):
        acc = p if acc is None else (acc + (p >> (c + 1))).astype(np.int32)
    return acc


def dot(a, b):
    """The bodies' dot_general with preferred_element_type int32 (exact)."""
    return (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)


def jax_dots(lhs, band, tn):
    """pallas_dots, body :80-86: nd dots a grid step."""
    nd = band.shape[1]
    out = np.zeros((CH, M, D), np.int32)
    for ch in range(CH):
        for j in range(D // tn):
            cols = slice(j * tn, (j + 1) * tn)
            out[ch, :, cols] = combine([dot(lhs[ch], band[ch, c][:, cols]) for c in range(nd)])
    return out


def jax_one_dot(lhs, band_m, tn):
    """pallas_one_dot, body :109-117: one dot on a [kd, nd, TN] block."""
    nd = band_m.shape[2]
    out = np.zeros((CH, M, D), np.int32)
    for ch in range(CH):
        for j in range(D // tn):
            blk = band_m[ch][:, :, j * tn:(j + 1) * tn]
            p = dot(lhs[ch], blk.reshape(KD, nd * tn)).reshape(M, nd, tn)
            out[ch, :, j * tn:(j + 1) * tn] = combine([p[:, c, :] for c in range(nd)])
    return out


def jax_wide_dot(lhs, band_w, tn, nd):
    """pallas_wide_dot, body :148-156: one dot on a [kd, nd*TN] tile."""
    out = np.zeros((CH, M, D), np.int32)
    for ch in range(CH):
        for j in range(D // tn):
            p = dot(lhs[ch], band_w[ch][:, j * nd * tn:(j + 1) * nd * tn])
            out[ch, :, j * tn:(j + 1) * tn] = combine(
                [p[:, c * tn:(c + 1) * tn] for c in range(nd)])
    return out


@pytest.mark.parametrize("nd", [5, 8])
@pytest.mark.parametrize("tn", [8, 32])
def test_layouts_equal_the_jax_layouts(nd, tn):
    _, band = operands(nd, nd + tn)
    t = torch.from_numpy(band)
    np.testing.assert_array_equal(ds.band_one_dot(t).numpy(), jax_band_m(band))
    np.testing.assert_array_equal(ds.band_wide(t, tn).numpy(), jax_band_w(band, tn))
    assert ds.band_layout(t, "planes") is t


@pytest.mark.parametrize("nd", [5, 8])
@pytest.mark.parametrize("tn", [8, 32])
def test_dot_structure_equals_the_jax_bodies(nd, tn):
    """Each layout's plain version and entry against its body's
    transcription, every output; the three give the same int32 [CH, m, D]."""
    lhs, band = operands(nd, 3 * nd + tn)
    want = jax_dots(lhs, band, tn)
    np.testing.assert_array_equal(jax_one_dot(lhs, jax_band_m(band), tn), want)
    np.testing.assert_array_equal(jax_wide_dot(lhs, jax_band_w(band, tn), tn, nd), want)
    tl = torch.from_numpy(lhs)
    for layout in ds.LAYOUTS:
        bx = ds.band_layout(torch.from_numpy(band), layout, tn)
        for fn in (ds.dot_structure_plain, ds.dot_structure):
            got = fn(tl, bx, layout, tn, nd)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{layout} {fn.__name__}")


@pytest.mark.parametrize("layout", ds.LAYOUTS)
def test_dot_operand_lays_out_once(layout):
    """``dot_operand`` keeps the values and the logical shape and stores k
    innermost on 16 bytes; a band that lies so is not copied again (kernel
    1's k-packed band is the planes layout as it lies)."""
    lhs, band = operands(5, 11)
    bx = ds.band_layout(torch.from_numpy(band), layout, 32)
    before = ds.dot_structure.relayouts
    laid = ds.dot_operand(bx, layout)
    assert ds.dot_structure.relayouts == before + 1
    assert torch.equal(laid, bx) and modmat.k_rows_ok(ds._rows(laid, layout))
    assert ds.dot_operand(laid, layout) is laid
    assert ds.dot_structure.relayouts == before + 1
    kpacked = modmat.k_rows(torch.from_numpy(band).transpose(-1, -2)).transpose(-1, -2)
    assert ds.dot_operand(kpacked, "planes") is kpacked


def test_dot_structure_refuses_what_it_cannot_run():
    lhs, band = operands(5, 1)
    tl, tb = torch.from_numpy(lhs), torch.from_numpy(band)
    with pytest.raises(ValueError, match="unknown layout"):
        ds.dot_structure(tl, tb, "stacked")
    with pytest.raises(ValueError, match="needs nd"):
        ds.dot_structure(tl, ds.band_wide(tb, 32), "wide", 32)
    with pytest.raises(ValueError, match="unsupported device"):
        ds.dot_structure(tl.to("meta"), tb.to("meta"), "planes")


def test_ptxas_report_reads_the_build_log(monkeypatch, tmp_path):
    """ptxas's registers and spills come from the log kept beside the
    library, so a cached build reports them as a fresh one does."""
    from pvw_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text("// a kernel\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.ptxas_report("k") == []
    log = _build.target("k").with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(
        "ptxas info    : Compiling entry function '_Z3dotILi8ELi2EEvPKa' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3dotILi8ELi2EEvPKa\n"
        "    0 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]\n")
    assert _build.ptxas_report("k") == [
        {"entry": "_Z3dotILi8ELi2EEvPKa", "template_args": [8, 2], "registers": 168,
         "spill_store_bytes": 24, "spill_load_bytes": 16}]
