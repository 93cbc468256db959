"""curdleproofs_tpu_torch.ops.modarith vs the JAX package's ops.modarith and
vs Python ints. CPU only; every comparison is integer equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.ops import modarith as jma
from curdleproofs_tpu.ops.fieldspec import FQ_SPEC as JFQ
from curdleproofs_tpu_torch.fields import FQ_MOD
from curdleproofs_tpu_torch.ops import modarith as tma
from curdleproofs_tpu_torch.ops.fieldspec import (
    FQ_SPEC,
    from_reference,
    ints_to_limbs,
    limbs_to_ints,
    to_reference,
)

P = FQ_MOD
R = 1 << 384
RINV = pow(R, -1, P)


def _values(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    edge = [0, 1, P - 1, P - 2, 2, (1 << 380) - 1, FQ_SPEC.r_mod, (1 << 16) - 1, 1 << 16]
    rnd = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n - len(edge))]
    return edge + rnd


A = _values(1)
B = list(reversed(_values(2)))  # pairs every edge value with a random one
B[:9] = [0, P - 1, P - 1, 1, P - 2, 1, 1, 0, P - 1]  # ... and edges with edges


def _both(vals):
    arr = np.asarray(ints_to_limbs(vals, 24), dtype=np.uint32)
    return from_reference(arr, "cpu"), jnp.asarray(arr)


BINARY = {
    "add": (tma.add, jma.add, lambda a, b: (a + b) % P),
    "sub": (tma.sub, jma.sub, lambda a, b: (a - b) % P),
    "mont_mul": (tma.mont_mul, jma.mont_mul, lambda a, b: a * b * RINV % P),
}
UNARY = {
    "neg": (tma.neg, jma.neg, lambda a: (-a) % P),
    "double": (tma.double, jma.double, lambda a: 2 * a % P),
    "mont_sqr": (tma.mont_sqr, jma.mont_sqr, lambda a: a * a * RINV % P),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_matches_jax_and_ints(name):
    tfn, jfn, ifn = BINARY[name]
    ta, ja = _both(A)
    tb, jb = _both(B)
    got = tfn(FQ_SPEC, ta, tb)
    assert got.dtype == torch.int32
    assert np.array_equal(to_reference(got), np.asarray(jfn(JFQ, ja, jb)))
    assert limbs_to_ints(got) == [ifn(a, b) for a, b in zip(A, B)]


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_matches_jax_and_ints(name):
    tfn, jfn, ifn = UNARY[name]
    ta, ja = _both(A)
    got = tfn(FQ_SPEC, ta)
    assert np.array_equal(to_reference(got), np.asarray(jfn(JFQ, ja)))
    assert limbs_to_ints(got) == [ifn(a) for a in A]


def test_predicates_and_select():
    ta, _ = _both(A)
    tb, _ = _both(B)
    assert to_reference(tma.is_zero(FQ_SPEC, ta)).tolist() == [a == 0 for a in A]
    assert to_reference(tma.eq(FQ_SPEC, ta, tb)).tolist() == [a == b for a, b in zip(A, B)]
    mask = torch.tensor([i % 3 == 0 for i in range(len(A))])
    sel = tma.select(mask, ta, tb)
    assert limbs_to_ints(sel) == [a if i % 3 == 0 else b for i, (a, b) in enumerate(zip(A, B))]


def test_batched_shapes_broadcast():
    """(24, W, n) operands and a (24, 1) constant column, as the MSM uses them."""
    ta, _ = _both(A)
    tb, _ = _both(B)
    a3 = torch.stack([ta, tb], dim=1)  # (24, 2, n)
    col = tb[:, :1].unsqueeze(1)  # (24, 1, 1)
    got = tma.mont_mul(FQ_SPEC, a3, col.expand_as(a3))
    want0 = [a * B[0] * RINV % P for a in A]
    want1 = [b * B[0] * RINV % P for b in B]
    assert limbs_to_ints(got[:, 0]) == want0
    assert limbs_to_ints(got[:, 1]) == want1


def test_cuda_field_constants_match_spec():
    """The 32-bit word constants in csrc/fq.cuh are p, R mod p and -p^-1."""
    import re
    from pathlib import Path

    import curdleproofs_tpu_torch

    src = (Path(curdleproofs_tpu_torch.__file__).parent / "csrc" / "fq.cuh").read_text()

    def words(name):
        body = re.search(name + r"\[FQ_WORDS\] = \{(.*?)\}", src, re.S).group(1)
        ws = [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9a-f]+u", body)]
        assert len(ws) == 12
        return sum(w << (32 * i) for i, w in enumerate(ws))

    assert words("FQ_P") == P
    assert words("FQ_ONE") == R % P
    n0 = int(re.search(r"FQ_N0INV = (0x[0-9a-f]+)u", src).group(1), 16)
    assert n0 == (-pow(P, -1, 1 << 32)) % (1 << 32)
