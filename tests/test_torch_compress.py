"""The port's batched point (de)compression (curdleproofs_tpu_torch.ops.compress)
on device="cpu" — the plain PyTorch chain that the card's kernels
(csrc/field_kernels.cu) are held against — against the
host decoder (csrc/g1_host.c and the oracle) and against the JAX package's
`ops.compress` on the same encodings: the cases of tests/test_compress.py,
the same SerdeError messages, and the routing of
`curve.decompress_host_batch` with DECOMPRESS_DEVICE_MIN patched low."""
import numpy as np
import pytest
import torch

from curdleproofs_tpu.ops import compress as jcompress
from curdleproofs_tpu.ops import g1 as jg1
from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.utils.errors import SerdeError as JSerdeError
from curdleproofs_tpu_torch import curve
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FQ_MOD, FR_MOD, Fr
from curdleproofs_tpu_torch.ops import compress as tcompress
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops.fieldspec import limbs_to_ints
from curdleproofs_tpu_torch.utils.errors import SerdeError

torch.set_num_threads(1)

N = 16


def rand_points(n, seed=0x51DE):
    rng = np.random.default_rng(seed)
    return curve.mul_host_batch([G1()] * n, [Fr(int.from_bytes(rng.bytes(32), "little") % FR_MOD) for _ in range(n)])


def _j(p):
    return JG1.identity() if p.inf else JG1(p.x, p.y)


def test_batch_decompress_matches_host_and_jax():
    pts = rand_points(N)
    pts[3] = G1.identity()
    pts[4] = -pts[5]  # both signs
    encs = [p.to_compressed_bytes() for p in pts]
    got = tcompress.batch_decompress_to_host(encs, "cpu")
    assert got == pts == curve.decompress_host_batch(b"".join(encs))
    jgot = jcompress.batch_decompress_to_host(encs)
    assert [(p.inf, p.x, p.y) if not p.inf else True for p in got] == [
        (q.inf, q.x, q.y) if not q.inf else True for q in jgot
    ]
    ap, infs = tcompress.batch_decompress(encs, "cpu")
    assert infs == [p.inf for p in pts] and ap.x.shape == (24, N) and ap.x.device.type == "cpu"
    # the packed tensors are the JAX package's, limb for limb (Montgomery form)
    jap, _ = jcompress.batch_decompress(encs)
    assert np.array_equal(ap.x.numpy().astype(np.uint32), np.asarray(jap.x))
    assert np.array_equal(ap.y.numpy().astype(np.uint32), np.asarray(jap.y))


def test_batch_compress_matches_host_and_jax():
    pts = rand_points(N, 7)
    pts[5] = G1.identity()
    encs = tcompress.batch_compress(og.pack_points(pts, "cpu"))
    assert encs == [p.to_compressed_bytes() for p in pts]
    assert b"".join(encs) == curve.compress_host_batch(pts)
    assert encs == jcompress.batch_compress(jg1.pack_points([_j(p) for p in pts]))


def test_round_trip_both_signs():
    p = G1() * Fr(7)
    encs = [q.to_compressed_bytes() for q in (p, -p)]
    assert encs[0] != encs[1]
    assert tcompress.batch_decompress_to_host(encs, "cpu") == [p, -p]


def test_parse_encodings_reads_x_sign_and_infinity():
    """The host parse that batch_decompress runs before the device chain:
    x limbs, the sign flag and the infinity flag of each encoding."""
    pts = rand_points(6, 11)
    pts[2] = G1.identity()
    pts[3] = -pts[4]
    x, signs, infs = tcompress.parse_encodings([p.to_compressed_bytes() for p in pts])
    assert x.shape == (24, 6)
    assert limbs_to_ints(x) == [0 if p.inf else p.x for p in pts]
    assert infs.tolist() == [p.inf for p in pts]
    assert signs.tolist() == [bool(p.to_compressed_bytes()[0] & 0x20) and not p.inf for p in pts]
    assert signs[3] != signs[4]


def _bad_batches():
    good = (G1() * Fr(3)).to_compressed_bytes()
    x = 1
    while curve.fq_sqrt((x**3 + 4) % FQ_MOD) is not None:
        x += 1
    off = bytearray(x.to_bytes(48, "big"))
    off[0] |= 0x80
    noncanon = bytearray(FQ_MOD.to_bytes(48, "big"))
    noncanon[0] |= 0x80
    return {
        "uncompressed": [good, bytes(48)],
        "wrong_length": [good[:-1]],
        "infinity_with_sign": [good, bytes([0xE0]) + bytes(47)],
        "infinity_with_x": [bytes([0xC0]) + bytes(46) + b"\x02", good],
        "non_canonical": [good, bytes(noncanon)],
        "off_curve": [good, good, bytes(off)],
    }


@pytest.mark.parametrize("case", sorted(_bad_batches()))
def test_malformed_batch_rejected_with_the_jax_message(case):
    encs = _bad_batches()[case]
    with pytest.raises(SerdeError) as e:
        tcompress.batch_decompress_to_host(encs, "cpu")
    with pytest.raises(JSerdeError) as je:
        jcompress.batch_decompress_to_host(encs)
    assert str(e.value) == str(je.value)


def test_decompress_host_batch_routes_to_the_device_code(monkeypatch):
    """From DECOMPRESS_DEVICE_MIN points an unchecked batch decodes on the
    caller's device (here the CPU, patched low); a checked one, and a smaller
    one, on the host backend. A bad element raises ValueError with the device
    decoder's message."""
    pts = rand_points(N, 11)
    blob = curve.compress_host_batch(pts)
    monkeypatch.setattr(curve, "DECOMPRESS_DEVICE_MIN", N)
    calls = []
    real = tcompress.batch_decompress_to_host
    monkeypatch.setattr(tcompress, "batch_decompress_to_host", lambda e, d: calls.append(d) or real(e, d))
    assert curve.decompress_host_batch(blob, device="cpu") == pts
    assert calls == [torch.device("cpu")]
    assert curve.decompress_host_batch(blob, check=True, device="cpu") == pts
    assert curve.decompress_host_batch(blob[:-48], device="cpu") == pts[:-1]
    assert len(calls) == 1
    bad = bytearray(blob)
    bad[48 * 9] &= 0x7F
    with pytest.raises(ValueError, match="encoding 9: uncompressed form not supported"):
        curve.decompress_host_batch(bytes(bad), device="cpu")
