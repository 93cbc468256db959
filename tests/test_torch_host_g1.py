"""The port's host G1 backend (csrc/g1_host.c through utils/host_native and
the batch helpers of curdleproofs_tpu_torch.curve) against the port's
pure-Python oracle and against the JAX package's `curve` functions on the
same inputs, made from a numpy seed; edge lanes, malformed, non-canonical,
off-curve and out-of-subgroup encodings; the frozen golden vectors of
tests/test_golden_vectors.py, copied here as data. Every check is equality."""
import numpy as np
import pytest

from curdleproofs_tpu import curve as jcurve
from curdleproofs_tpu.fields import Fr as JFr
from curdleproofs_tpu_torch import curve
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FQ_MOD, FR_MOD, Fr
from curdleproofs_tpu_torch.utils import host_native

SEED = 0x61

# ---- frozen vectors of tests/test_golden_vectors.py (an independent affine
# implementation from the published decimal parameters made them) ----------
_R = FR_MOD
KG_VECTORS = [
    (0x1, "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac586c55e83ff97a1aeffb3af00adb22c6bb"),
    (0x2, "a572cbea904d67468808c8eb50a9450c9721db309128012543902d0ac358a62ae28f75bb8f1c7c42c39a8c5529bf0f4e"),
    (0x3, "89ece308f9d1f0131765212deca99697b112d61f9be9a5f1f3780a51335b3ff981747a0b2ca2179b96d2c0c9024e5224"),
    (0x4, "ac9b60d5afcbd5663a8a44b7c5a02f19e9a77ab0a35bd65809bb5c67ec582c897feb04decc694b13e08587f3ff9b5b60"),
    (0x5, "b0e7791fb972fe014159aa33a98622da3cdc98ff707965e536d8636b5fcc5ac7a91a8c46e59a00dca575af0f18fb13dc"),
    (0x7, "b928f3beb93519eecf0145da903b40a4c97dca00b21f12ac0df3be9116ef2ef27b2ae6bcd4c5bc2d54ef5a70627efcb7"),
    (0x8, "a85ae765588126f5e860d019c0e26235f567a9c0c0b2d8ff30f3e8d436b1082596e5e7462d20f5be3764fd473e57f9cf"),
    (0xFF, "97e827da16cbd1da013b125a96b24770e0cad7e5af0ccd9fb75a60d8ba426891489d44497b091e1b0383f457f1b2251c"),
    (0x100, "8025cdadf2afc5906b2602574a799f4089d90f36d73f94c1cf317cfc1a207c57f232bca6057924dd34cff5bde87f1930"),
    (0x10001, "88cab01b6d06a323e18f50141a694e7e71ab18ffdfab536a45ccf0b49a634ee82d00750e9f4c15d806c33a8950664d7f"),
    (0x10000000000000000, "814857e17b2a0eaa5aa6e4f7fc894c8437bd537efb294e79fd253ec4d3fbe3b3d10f142e687325506111f54e8c78162c"),
    (0x100000000000000000000000000000000, "a1bf5306c66b2a7a583e7c573146ff639ab1000beb9f86c3d0a7e79b3009884d2cf15d868e7f0d3af1c43c35ffa3097f"),
    (0x1000000000000000000000000000000000000000000000000, "854176e8cadd89461af2e044a47da9bc5646ab24a3204dd16a5f1e3315b39b88b26cc1d552d01a0b8d1bc26d8570646d"),
    (0x4000000000000000000000000000000000000000000000000000000000000000, "876072f7a9319cd7dca9f2d4dcb26a17acb8a245eacf79e0c783938afb7689d64744e713946e0505a3031f047cf133fc"),
    (_R - 1, "b7f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac586c55e83ff97a1aeffb3af00adb22c6bb"),
    (_R - 2, "8572cbea904d67468808c8eb50a9450c9721db309128012543902d0ac358a62ae28f75bb8f1c7c42c39a8c5529bf0f4e"),
    ((_R - 1) // 2, "87726dc031bd26122395153ca428d5e6dea0a64c1f9b3b1bb2f2508a5eb6ea0ea0363294fad3160858bc87e46d3422fd"),
    ((_R + 1) // 2, "a7726dc031bd26122395153ca428d5e6dea0a64c1f9b3b1bb2f2508a5eb6ea0ea0363294fad3160858bc87e46d3422fd"),
    (0xAC45A4010001A40200000000FFFFFFFF, "88dc871d10797b5a25bde7201bbfa0785d137ce284469115be39e624c5fa86c95c11019fdc94281f53de9bf71abf187b"),
    (0xAC45A4010001A4020000000100000000, "b333c91030ee7a4649e404c01b2e0d26a8728dd7cb4edb636ed984de104bb92674f1161d8c99bcf024e473fe0a1d7620"),
    (0x6AC0179CA1613D75DEFA7E708709F5E9BC3027A68766E722AABBCCDEEEFF0010, "81ccb739a277f297f9413e326ee3bf06513554ac7adad5bd5b4cd31d356224af09e300ffffec14c0d183deaaa2ee995c"),
    (0x1FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF, "b0f1777d1c9b6de0a5ea6d03d611face090d4e1dd94e232affa67e9dab1e06dbbaff76959cffa4a76961239a207f1c95"),
]
MSM8_SCALARS = [3, 1, 4, 1, 5, 9, 2, 6]
MSM8 = "b43dc65ed3a3cca3400886264d7b5bae83ef60ecb82e1195902090020a0e57d16df36a05a90b05a2f9a6e968ea08a79f"
MSM8_BIG_SCALARS = [_R - 1, _R - 2, 2**200 % _R, 1, 0, 12345, 2**254 % _R, 7]
MSM8_BIG = "937de9e7326e9289ac862380b4ffd512c22cfa89d6134e387e020e53f62c59cae0b4e8637a475ef66dd0cf659149fe65"
SUM_ALL = "813f300ded72c65b0191f9d54424440acdc5ea926a43be8d02e047be31f74934708ae730e4d316586928ffb12ea1672f"
P5_XY = (
    2601793266141653880357945339922727723793268013331457916525213050197274797722760296318099993752923714935161798464476,
    3498096627312022583321348410616510759186251088555060790999813363211667535344132702692445545590448314959259020805858,
)


def _scalars(n, seed=SEED):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]


def _points(n, seed=SEED):
    return [G1() * Fr(k) for k in _scalars(n, seed + 1)]


def _j(p: G1):
    return jcurve.G1.identity() if p.inf else jcurve.G1(p.x, p.y)


def _same(p: G1, q) -> bool:
    return (p.inf and q.inf) or (not p.inf and not q.inf and (p.x, p.y) == (q.x, q.y))


def _edge_lanes(n=12):
    """Random lanes plus the edges: identity operands, a zero scalar, P + P
    and P + (-P)."""
    pts = _points(n)
    a, b = list(pts), list(reversed(pts))
    a[0] = G1.identity()
    b[1] = G1.identity()
    a[2] = b[2] = G1.identity()
    b[3] = a[3]  # P + P
    b[4] = -a[4]  # P + (-P)
    scs = [Fr(s) for s in _scalars(n, SEED + 7)]
    scs[5] = Fr(0)
    scs[6] = Fr(FR_MOD - 1)
    scs[7] = Fr(1)
    return a, b, scs


def test_the_native_backend_is_taken():
    assert host_native.available() and curve.native_enabled()
    with curve.oracle():
        assert not curve.native_enabled()
    assert curve.native_enabled()


def test_batch_helpers_equal_the_oracle_and_jax():
    a, b, scs = _edge_lanes()
    with curve.oracle():
        want = {
            "add": curve.add_host_batch(a, b),
            "mul": curve.mul_host_batch(a, scs),
            "msm": curve.msm_host(a, scs),
            "sum": curve.g1_sum(a + b),
            "comp": curve.compress_host_batch(a + b),
        }
    got = {
        "add": curve.add_host_batch(a, b),
        "mul": curve.mul_host_batch(a, scs),
        "msm": curve.msm_host(a, scs),
        "sum": curve.g1_sum(a + b),
        "comp": curve.compress_host_batch(a + b),
    }
    assert got == want
    ja, jb, js = [_j(p) for p in a], [_j(p) for p in b], [JFr(s.v) for s in scs]
    assert all(map(_same, got["add"], jcurve.add_host_batch(ja, jb)))
    assert all(map(_same, got["mul"], jcurve.mul_host_batch(ja, js)))
    assert _same(got["msm"], jcurve.msm_host(ja, js))
    assert _same(got["sum"], jcurve.g1_sum(ja + jb))
    assert got["comp"] == jcurve.compress_host_batch(ja + jb)
    # the edge lanes themselves
    assert got["add"][3] == a[3] * Fr(2) and got["add"][4].inf
    assert got["mul"][5].inf and got["mul"][0].inf and got["mul"][6] == -a[6]
    assert curve.msm_host([], []).inf and curve.g1_sum([]).inf


@pytest.mark.parametrize("n", [1, 2, 5, 300])
def test_msm_host_at_every_branch(n):
    """n = 1 (the single GLV multiply), small Pippenger windows, and a wider
    one, against the oracle and the JAX package."""
    pts = _points(n, SEED + n)
    scs = [Fr(s) for s in _scalars(n, SEED + 2 * n)]
    got = curve.msm_host(pts, scs)
    if n <= 5:
        with curve.oracle():
            assert got == curve.msm_host(pts, scs)
    assert _same(got, jcurve.msm_host([_j(p) for p in pts], [JFr(s.v) for s in scs]))


def test_msm_host_on_its_threaded_branch():
    """From 4,096 points the Pippenger windows run across OpenMP threads:
    held against sum k_i s_i * G for bases k_i * G (discrete logs known)."""
    ks, ss = _scalars(4100, 3), _scalars(4100, 4)
    pts = curve.mul_host_batch([G1()] * len(ks), [Fr(k) for k in ks])
    got = curve.msm_host(pts, [Fr(s) for s in ss])
    assert got == G1() * Fr(sum(k * s for k, s in zip(ks, ss)) % FR_MOD)


def test_g1_methods_dispatch_natively_and_agree():
    p, q = _points(2, SEED + 11)
    s = Fr(_scalars(1, SEED + 12)[0])
    native = (p + q, p - q, p * s, p.__rmul__(s), p + p, p - p, p.in_subgroup(), G1.identity() * s)
    with curve.oracle():
        oracle = (p + q, p - q, p * s, p.__rmul__(s), p + p, p - p, p.in_subgroup(), G1.identity() * s)
    assert native == oracle
    jp, jq = _j(p), _j(q)
    assert _same(native[0], jp + jq) and _same(native[2], jp * JFr(s.v))


def test_golden_vectors():
    ks = [Fr(k) for k, _ in KG_VECTORS]
    pts = curve.mul_host_batch([G1()] * len(ks), ks)
    blob = curve.compress_host_batch(pts)
    for i, (k, hexenc) in enumerate(KG_VECTORS):
        assert blob[48 * i : 48 * i + 48].hex() == hexenc, hex(k)
        assert (G1() * Fr(k)).to_compressed_bytes().hex() == hexenc
    bases = pts[:8]
    for scalars, want in ((MSM8_SCALARS, MSM8), (MSM8_BIG_SCALARS, MSM8_BIG)):
        assert curve.msm_host(bases, [Fr(s) for s in scalars]).to_compressed_bytes().hex() == want
    assert curve.g1_sum(pts).to_compressed_bytes().hex() == SUM_ALL
    enc5 = bytes.fromhex(KG_VECTORS[4][1])
    for dec in (G1.from_compressed_bytes, G1.from_compressed_bytes_unchecked):
        assert (dec(enc5).x, dec(enc5).y) == P5_XY
    flipped = bytes([enc5[0] ^ 0x20]) + enc5[1:]
    assert (G1.from_compressed_bytes_unchecked(flipped).y) == FQ_MOD - P5_XY[1]
    decoded = curve.decompress_host_batch(b"".join(bytes.fromhex(h) for _, h in KG_VECTORS))
    assert decoded == pts


def _off_curve_x() -> int:
    x = 1
    while curve.fq_sqrt((x**3 + 4) % FQ_MOD) is not None:
        x += 1
    return x


def _outside_subgroup() -> G1:
    """A curve point of the full group E(Fq) that is not in G1."""
    x = 1
    while True:
        y = curve.fq_sqrt((x**3 + 4) % FQ_MOD)
        if y is not None:
            p = G1(x, y)
            with curve.oracle():
                if not p.in_subgroup():
                    return p
        x += 1


def _bad_encodings():
    good = (G1() * Fr(3)).to_compressed_bytes()
    xoff = _off_curve_x()
    off_curve = bytearray(xoff.to_bytes(48, "big"))
    off_curve[0] |= 0x80
    noncanon = bytearray(FQ_MOD.to_bytes(48, "big"))
    noncanon[0] |= 0x80
    return {
        "uncompressed": bytes([good[0] & 0x7F]) + good[1:],
        "zero": bytes(48),
        "inf_with_sign": bytes([0xE0]) + bytes(47),
        "inf_with_x": bytes([0xC0]) + bytes(46) + b"\x01",
        "inf_low_flags": bytes([0xC1]) + bytes(47),
        "non_canonical": bytes(noncanon),
        "off_curve": bytes(off_curve),
    }


@pytest.mark.parametrize("case", sorted(_bad_encodings()))
def test_bad_encodings_raise_the_oracles_error(case):
    enc = _bad_encodings()[case]
    good = (G1() * Fr(5)).to_compressed_bytes()

    def error(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    for check in (False, True):
        dec = G1.from_compressed_bytes if check else G1.from_compressed_bytes_unchecked
        jdec = jcurve.G1.from_compressed_bytes if check else jcurve.G1.from_compressed_bytes_unchecked
        native = error(lambda: dec(enc))
        with curve.oracle():
            oracle = error(lambda: dec(enc))
            oracle_batch = error(lambda: curve.decompress_host_batch(good + enc, check))
        assert native == oracle == error(lambda: jdec(enc)) == oracle_batch
        assert error(lambda: curve.decompress_host_batch(good + enc + good, check)) == native
        assert error(lambda: jcurve.decompress_host_batch(good + enc, check)) == native


def test_points_outside_the_subgroup():
    p = _outside_subgroup()
    assert p.is_on_curve() and not p.in_subgroup()
    enc = p.to_compressed_bytes()
    assert G1.from_compressed_bytes_unchecked(enc) == p
    assert curve.decompress_host_batch(enc) == [p]
    with pytest.raises(ValueError, match="not in the prime-order subgroup") as e:
        G1.from_compressed_bytes(enc)
    with pytest.raises(ValueError) as ej:
        jcurve.G1.from_compressed_bytes(enc)
    assert str(e.value) == str(ej.value)
    good = G1() * Fr(9)
    pb, ib = curve._enc_batch([good, G1.identity(), p])
    assert host_native.g1_subgroup_check_batch(pb, ib) == 2
    assert host_native.g1_subgroup_check_batch(pb[:192], ib[:2]) == -1


def test_threaded_decode_reports_the_first_bad_element():
    """From 2,048 points the native decode splits across threads; a bad
    encoding in a later chunk still raises the oracle's error, and a good
    batch decodes to the same points as one call."""
    n = 2100
    pts = curve.mul_host_batch([G1()] * n, [Fr(k) for k in _scalars(n, 21)])
    pts[7] = G1.identity()
    blob = curve.compress_host_batch(pts)
    assert curve.decompress_host_batch(blob) == pts
    bad = bytearray(blob)
    bad[48 * 2000] &= 0x7F
    with pytest.raises(ValueError, match="uncompressed G1 encodings are not supported"):
        curve.decompress_host_batch(bytes(bad))


def test_jacobian_to_affine_batch_equals_the_oracle():
    pts = _points(6, SEED + 31)
    rng = np.random.default_rng(SEED + 32)
    triples, want = [], []
    for p in pts + [G1.identity()]:
        if p.inf:
            triples.append((1, 1, 0))
            want.append(p)
            continue
        z = int.from_bytes(rng.bytes(48), "big") % (FQ_MOD - 1) + 1
        triples.append((p.x * z * z % FQ_MOD, p.y * z * z * z % FQ_MOD, z))
        want.append(G1._from_jacobian(triples[-1]))
    blob = b"".join(c.to_bytes(48, "big") for t in triples for c in t)
    got = curve._dec_batch(*host_native.g1_jacobian_to_affine_batch(blob))
    assert got == want == pts + [G1.identity()]


def test_length_mismatches_are_refused():
    pb, ib = curve._enc_batch(_points(2))
    for call in (
        lambda: host_native.g1_msm(pb, ib, bytes(32)),
        lambda: host_native.g1_mul_batch(pb[:96], ib, bytes(64)),
        lambda: host_native.g1_add_batch(pb, ib, pb[:96], ib[:1]),
        lambda: host_native.g1_decompress_batch(bytes(47), False),
        lambda: host_native.g1_jacobian_to_affine_batch(bytes(100)),
        lambda: curve.decompress_host_batch(bytes(50)),
        lambda: G1.from_compressed_bytes_unchecked(bytes(47)),
    ):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("source", ["g1_host.c", "keccak.c"])
def test_entry_point_bindings_match_their_c_declarations(source):
    """Each ctypes binding of the two new sources has the argument count and
    kinds (pointer, 64-bit or plain int) of its C declaration."""
    import ctypes
    import re

    text = (host_native.CSRC_DIR / source).read_text()
    decls = re.findall(r"^int (curdle_\w+)\(([^)]*)\)", text, re.M)
    assert len(decls) == {"g1_host.c": 8, "keccak.c": 7}[source]
    for name, args in decls:
        kinds = ["ptr" if "*" in a else ("i64" if "int64_t" in a else "int") for a in args.split(",")]
        bound = [
            "ptr" if t is ctypes.c_char_p else ("i64" if t is ctypes.c_int64 else "int")
            for t in host_native.ENTRY_POINTS[name]
        ]
        assert kinds == bound, name
