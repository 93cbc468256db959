"""The port's transcript (curdleproofs_tpu_torch.transcript): the public
conformance vectors of tests/test_transcript.py (keccak, STROBE, Merlin) on
both of its backends, the native duplex (csrc/keccak.c) against the port's
Python Strobe128 on one mixed script, and the port against the JAX
package's Transcript on the same absorb-and-challenge script. Equality
throughout."""
import pytest

from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.fields import Fr as JFr
from curdleproofs_tpu.transcript import Transcript as JTranscript
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.transcript import (
    CurdleproofsTranscript,
    MerlinTranscript,
    Strobe128,
    Transcript,
    keccak_f1600,
)
from curdleproofs_tpu_torch.transcript import oracle
from curdleproofs_tpu_torch.utils import host_native
from curdleproofs_tpu_torch.vectors import PointVec, ScalarVec

BACKENDS = ["native", "python"]


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    monkeypatch.setenv("CURDLEPROOFS_TRANSCRIPT_NATIVE", "1" if request.param == "native" else "0")
    assert oracle.native_enabled() == (request.param == "native")
    return request.param


def test_keccak_f1600_known_vector():
    for out in (keccak_f1600(bytes(200)), host_native.keccak_f1600(bytes(200))):
        assert int.from_bytes(out[:8], "little") == 0xF1258F7940E1DDE7
        assert int.from_bytes(out[8:16], "little") == 0x84D5CCF933C0478A
    st = bytes(range(200))
    assert bytes(keccak_f1600(st)) == host_native.keccak_f1600(st) != st


def _native_strobe(label: bytes):
    ba = bytearray(host_native.STROBE_STATE_BYTES)
    st = host_native.strobe_state(ba)
    host_native.strobe_init(st, label)
    return ba, st


def test_strobe_conformance_both_backends():
    msg = bytes([99]) * 1024
    s = Strobe128(b"Conformance Test Protocol")
    ba, st = _native_strobe(b"Conformance Test Protocol")
    s.meta_ad(b"ms", False)
    s.meta_ad(b"g", True)
    s.ad(msg, False)
    host_native.strobe_op(st, 0, b"ms")
    host_native.strobe_op(st, 0, b"g", more=True)
    host_native.strobe_op(st, 1, msg)
    assert bytes(s.state) == bytes(ba[:200])
    s.meta_ad(b"prf", False)
    host_native.strobe_op(st, 0, b"prf")
    prf = s.prf(32, False)
    assert prf.hex() == "b48e645ca17c667fd5206ba57a6a228d72d8e1903814d3f17f622996d7cfefb0"
    assert host_native.strobe_op(st, 3, n=32) == bytes(prf)
    s.meta_ad(b"key", False)
    s.key(bytes(prf), False)
    host_native.strobe_op(st, 0, b"key")
    host_native.strobe_op(st, 2, bytes(prf))
    s.meta_ad(b"prf", False)
    host_native.strobe_op(st, 0, b"prf")
    prf = s.prf(32, False)
    assert prf.hex() == "07e45cce8078cee259e3e375bb85d75610e2d1e1201c5f645045a194edd49ff8"
    assert host_native.strobe_op(st, 3, n=32) == bytes(prf)
    assert (ba[200], ba[201], ba[202]) == (s.pos, s.pos_begin, s.cur_flags)


def test_strobe_flag_mismatch_rejected_by_both():
    s = Strobe128(b"proto")
    s.meta_ad(b"a", False)
    with pytest.raises(ValueError, match="mismatched flags"):
        s.ad(b"b", True)
    _, st = _native_strobe(b"proto")
    host_native.strobe_op(st, 0, b"a")
    with pytest.raises(ValueError, match="STROBE op continuation with mismatched flags"):
        host_native.strobe_op(st, 1, b"b", more=True)
    with pytest.raises(ValueError, match="bad strobe opcode"):
        host_native.strobe_op(st, 7, b"")
    with pytest.raises(ValueError, match="203-byte"):
        host_native.strobe_state(bytearray(200))
    with pytest.raises(ValueError, match="bad length"):
        host_native.merlin_write_many(st, b"l", bytes(10), 3)


def test_merlin_conformance(backend):
    t = MerlinTranscript(b"test protocol")
    assert (t._st is not None) == (backend == "native")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    )


def test_merlin_chunked_absorb_equivalence(backend):
    t1 = MerlinTranscript(b"chunks")
    t1.append_message(b"m", bytes(range(256)) * 3)
    t2 = MerlinTranscript(b"chunks")
    t2.append_message(b"m", bytearray(bytes(range(256)) * 3))
    assert t1.challenge_bytes(b"c", 64) == t2.challenge_bytes(b"c", 64)


def test_challenge_scalar_in_range_and_deterministic(backend):
    def draw():
        t = CurdleproofsTranscript(b"curdleproofs")
        t.append(b"lbl", b"payload")
        return t, t.get_and_append_challenge(b"chal")

    t1, c1 = draw()
    _, c2 = draw()
    assert isinstance(c1, Fr) and c1 == c2 and 0 < c1.v < FR_MOD
    assert t1.get_and_append_challenge(b"chal") != c1


def _script(T, G, F, pv, sv):
    """One absorb-and-challenge script over every item kind the protocol
    absorbs: bytes, u64, Fr, G1, point and scalar vectors, nested lists,
    byte reads across the rate boundary, one and many Fr draws."""
    t = T(b"equiv-test")
    t.absorb(b"m", b"hello", b"world" * 40)
    t.absorb_u64(b"u", 0xDEADBEEF)
    t.absorb(b"pts", G() * F(5), pv, [G() * F(7), [F(11), b"x"]])
    t.absorb(b"sc", sv, F(FR_MOD - 1))
    out = [bytes(t.squeeze_bytes(b"c", 7)), bytes(t.squeeze_bytes(b"c", 200))]
    out += [s.v for s in t.scalars(b"vec", 40)]
    t.absorb(b"m2", b"x" * 166)  # exactly one rate block
    out.append(bytes(t.squeeze_bytes(b"c2", 32)))
    out.append(t.scalar(b"one").v)
    return out


def test_native_duplex_equals_python_strobe(monkeypatch):
    pv = PointVec([G1() * Fr(k) for k in (2, 3, 4)] + [G1.identity()])
    sv = ScalarVec.of([1, 2, FR_MOD - 3])
    native = _script(Transcript, G1, Fr, pv, sv)
    monkeypatch.setenv("CURDLEPROOFS_TRANSCRIPT_NATIVE", "0")
    py = _script(Transcript, G1, Fr, pv, sv)
    assert native == py


def test_port_equals_the_jax_transcript(backend):
    from curdleproofs_tpu.vectors import PointVec as JPointVec
    from curdleproofs_tpu.vectors import ScalarVec as JScalarVec

    ks = (2, 3, 4)
    pv = PointVec([G1() * Fr(k) for k in ks] + [G1.identity()])
    sv = ScalarVec.of([1, 2, FR_MOD - 3])
    jpv = JPointVec([JG1() * JFr(k) for k in ks] + [JG1.identity()])
    jsv = JScalarVec.of([1, 2, FR_MOD - 3])
    assert _script(Transcript, G1, Fr, pv, sv) == _script(JTranscript, JG1, JFr, jpv, jsv)
