"""The plain reference against the port on the CPU: the CRS, the public
keys, ciphertext columns of a round and a decryption, bit for bit, at the
toy preset and at both configurations' chains with k and n cut."""

import numpy as np
import pytest
import torch
from pb_small import REPO

import pvw_tpu_torch as P
from pvw_tpu_torch.params import presets
from portbench.reference import pvw as ref


def chain(name):
    import json

    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def toy_cfg():
    p = presets.toy(8)
    return {"n": 8, "k": p.k, "l": p.l, "moduli": list(p.ring.moduli),
            "secret_variance": p.secret_variance, "error_bound_1": p.error_bound_1,
            "error_bound_2": p.error_bound_2, "settings": {"noise_stream": "v3k"}}


CASES = {"toy": toy_cfg, "ref128-k16": lambda: {**chain("ref128-n1024"), "k": 16, "n": 8},
         "t256-k8": lambda: {**chain("t256-n1024"), "k": 8, "n": 8}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_port(case, monkeypatch):
    cfg = CASES[case]()
    monkeypatch.setattr(P.settings, "noise_stream", "v3k")
    n, k, l = cfg["n"], cfg["k"], cfg["l"]
    p = (P.PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(l)
         .set_moduli(cfg["moduli"]).set_secret_variance(cfg["secret_variance"])
         .set_error_bounds_u32(cfg["error_bound_1"], cfg["error_bound_2"]).build())
    sch = ref.Scheme(cfg, "cpu")
    assert sch.delta == p.delta()
    master = ref.key(2**33 + 7)
    kcrs, kgen, kround = (ref.fold_in(master, i) for i in (1, 2, 3))
    crs = P.PvwCrs.new(p, kcrs, device="cpu")
    A = sch.crs(kcrs)
    assert torch.equal(A, crs.matrix.res)
    g = torch.Generator().manual_seed(5)
    w = torch.randint(0, 1 << 32, (2, n, k, l), generator=g)
    coeffs = ref.cbd_from_words(w[0], w[1], cfg["secret_variance"]).to(torch.int32)
    gpk = P.GlobalPublicKey(crs)
    gpk.generate_all_keys_device(coeffs, kgen)
    parties = torch.arange(n)
    B = sch.public_rows(A, coeffs, kgen, parties)
    assert torch.equal(B, gpk.matrix.res)
    shares = np.random.default_rng(1).integers(0, 2**64 - 1, (n, n), np.uint64, endpoint=True)
    ct = P.encrypt_all_party_shares_batched(shares, gpk, kround)
    dealers = torch.tensor([0, n // 2, n - 1])
    c1, c2 = sch.encrypt_columns(A, B, parties, kround, dealers,
                                 torch.from_numpy(shares.view(np.int64))[dealers])
    assert torch.equal(c1, ct.c1.channel()[..., dealers].permute(2, 3, 0, 1))
    assert torch.equal(c2, ct.c2.channel()[..., dealers].permute(2, 3, 0, 1))
    # a decryption of party 1: the reference's exact decode, the program's, the plaintext
    z = sch.noisy_messages(coeffs[1], c1, c2[1])
    got = [ref.decode(sch, zz) for zz in ref.lift(sch, z)]
    want = [ref.expected_share(int(shares[d, 1]), sch.ring.Q) for d in dealers.tolist()]
    prog = dict(P.decrypt_valid_shares(ct, list(range(n)), 1, P.SecretKey(p, coeffs[1].numpy()), 1))
    assert got == want == [prog[d] for d in dealers.tolist()]


def test_exact_products_mod_q():
    q = torch.tensor([(1 << 61) - 1, 0x800000022A0001])
    x = torch.randint(0, 1 << 62, (2, 3, 40)) % q[:, None, None]
    y = torch.randint(0, 1 << 62, (2, 40, 5)) % q[:, None, None]
    got = ref.matmul_mod(x, y, q)
    for c in range(2):
        qq = int(q[c])
        want = [[sum(int(x[c, i, t]) * int(y[c, t, j]) for t in range(40)) % qq
                 for j in range(5)] for i in range(3)]
        assert got[c].tolist() == want
    a, b = x[:, :, :5], y[:, :3, :]
    assert ref.mulmod(a, b, q[:, None, None]).tolist() == [
        [[int(a[c, i, j]) * int(b[c, i, j]) % int(q[c]) for j in range(5)] for i in range(3)]
        for c in range(2)]


def test_bounded_draws_against_python_ints():
    w = [torch.randint(0, 1 << 32, (200,)) for _ in range(4)]
    for rng in (3, (1 << 30) + 5, 0x800000022A0001, (1 << 61) - 1):
        X = [(int(w[0][i]) << 96) | (int(w[1][i]) << 64) | (int(w[2][i]) << 32) | int(w[3][i])
             for i in range(200)]
        assert ref.reduce128(w, rng).tolist() == [x * rng >> 128 for x in X]
    X96 = [(int(w[0][i]) << 64) | (int(w[1][i]) << 32) | int(w[2][i]) for i in range(200)]
    assert ref.reduce96(w[0], w[1], w[2], 2345679).tolist() == [x * 2345679 >> 96 for x in X96]


def test_reference_finds_its_stream_by_name():
    assert callable(ref.stream("v3k").noise) and callable(ref.stream("v3k").randomness)
    with pytest.raises(FileNotFoundError, match="streams/kernel.py"):
        ref.Scheme({**chain("t256-n1024"), "k": 8, "n": 8, "settings": {}}, "cpu")
