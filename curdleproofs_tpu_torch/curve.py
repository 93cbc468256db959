"""Exact host-side BLS12-381 G1 group arithmetic and compressed serialization.

This is the host orchestration / serde / oracle counterpart of the CUDA kernels
behind `curdleproofs_tpu_torch.ops.g1`. Two backends give the same values:
the pure-Python code of this file, which is the oracle, and the package's
native host library (csrc/g1_host.c through utils/host_native), which the
`G1` methods and the batch helpers take wherever the library can be built.
The choice is made at the first call, not at import. The behaviour contract
mirrors the reference's native `G1Point`
(py_arkworks_bls12381-stubs/__init__.pyi:5-30): add/sub/neg, scalar mul,
identity, equality, ZCash 48-byte compressed encode/decode with checked
(subgroup-verifying) and unchecked variants. The generator's canonical
compressed form is pinned in tests (reference test_curdleproofs.py:179-180).

Internally points are affine (x, y) Python ints with an infinity flag; scalar
multiplication runs through Jacobian coordinates to avoid per-step inversions.
"""
from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Tuple

from curdleproofs_tpu_torch.fields import (
    CURVE_B,
    FQ_MOD as P,
    FR_MOD,
    Fr,
    G1_GEN_X,
    G1_GEN_Y,
)
from curdleproofs_tpu_torch.utils import host_native

# Jacobian point = (X, Y, Z) ints; Z == 0 encodes infinity.
_JINF = (1, 1, 0)


def _jdbl(pt: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Jacobian doubling, a = 0 curve (2M + 5S)."""
    x, y, z = pt
    if z == 0:
        return _JINF
    a = x * x % P
    b = y * y % P
    c = b * b % P
    t = x + b
    d = 2 * (t * t - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def _jadd(p1: Tuple[int, int, int], p2: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Complete Jacobian addition (handles inf / equal / negated inputs)."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if z1 == 0:
        return p2
    if z2 == 0:
        return p1
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 == s2:
            return _jdbl(p1)
        return _JINF
    h = (u2 - u1) % P
    i = 4 * h * h % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) % P * h % P
    return (x3, y3, z3)


def _jmul(pt: Tuple[int, int, int], k: int) -> Tuple[int, int, int]:
    """Left-to-right double-and-add with a 4-bit window (k >= 0, unreduced)."""
    if k == 0 or pt[2] == 0:
        return _JINF
    # window precomputation: pt * 1..15
    tbl = [None, pt]  # type: ignore[list-item]
    for i in range(2, 16):
        tbl.append(_jadd(tbl[i - 1], pt))
    acc = _JINF
    started = False
    for shift in range(k.bit_length() + (4 - k.bit_length() % 4) % 4 - 4, -4, -4):
        if started:
            acc = _jdbl(_jdbl(_jdbl(_jdbl(acc))))
        w = (k >> shift) & 0xF
        if w:
            acc = _jadd(acc, tbl[w])
            started = True
    return acc


def _to_affine(pt: Tuple[int, int, int]) -> Optional[Tuple[int, int]]:
    x, y, z = pt
    if z == 0:
        return None
    zinv = pow(z, -1, P)
    zinv2 = zinv * zinv % P
    return (x * zinv2 % P, y * zinv2 % P * zinv % P)


def fq_sqrt(a: int) -> Optional[int]:
    """Square root in Fq (p ≡ 3 mod 4 → a^((p+1)/4)); None if non-residue."""
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a else None


class G1:
    """BLS12-381 G1 point, exact host-side representation."""

    __slots__ = ("x", "y", "inf")

    def __init__(self, x: Optional[int] = None, y: Optional[int] = None) -> None:
        if x is None:
            # default-constructed point is the generator, matching the
            # reference backend (G1Point() == generator; util.py:9)
            self.x, self.y, self.inf = G1_GEN_X, G1_GEN_Y, False
        else:
            assert y is not None
            self.x, self.y, self.inf = x % P, y % P, False

    @classmethod
    def identity(cls) -> "G1":
        p = cls.__new__(cls)
        p.x, p.y, p.inf = 0, 0, True
        return p

    @classmethod
    def generator(cls) -> "G1":
        return cls()

    @classmethod
    def _from_jacobian(cls, pt: Tuple[int, int, int]) -> "G1":
        aff = _to_affine(pt)
        if aff is None:
            return cls.identity()
        return cls(aff[0], aff[1])

    def _jacobian(self) -> Tuple[int, int, int]:
        return _JINF if self.inf else (self.x, self.y, 1)

    # -- group ops ----------------------------------------------------------

    def __add__(self, other: "G1") -> "G1":
        if native_enabled():
            return _nat_add(self, other)
        return G1._from_jacobian(_jadd(self._jacobian(), other._jacobian()))

    def __sub__(self, other: "G1") -> "G1":
        return self + (-other)

    def __neg__(self) -> "G1":
        if self.inf:
            return self
        return G1(self.x, P - self.y)

    def __mul__(self, scalar: Fr) -> "G1":
        if native_enabled():
            return _nat_mul(self, scalar)
        return G1._from_jacobian(_jmul(self._jacobian(), scalar.v))

    def __rmul__(self, scalar: Fr) -> "G1":
        return self.__mul__(scalar)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, G1):
            return NotImplemented
        if self.inf or other.inf:
            return self.inf and other.inf
        return self.x == other.x and self.y == other.y

    # Intentionally unhashable, like the reference backend's G1Point
    # (test_curdleproofs.py:186-191); index by compressed bytes instead.
    __hash__ = None  # type: ignore[assignment]

    def is_identity(self) -> bool:
        return self.inf

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        return self.y * self.y % P == (self.x * self.x % P * self.x + CURVE_B) % P

    def in_subgroup(self) -> bool:
        if native_enabled():
            pb, ib = _enc96(self)
            return host_native.g1_subgroup_check_batch(pb, bytes([ib])) < 0
        return G1._from_jacobian(_jmul(self._jacobian(), FR_MOD)).inf

    # -- serde: ZCash 48-byte compressed encoding ---------------------------
    # byte 0 flags: 0x80 compressed, 0x40 infinity, 0x20 y lexicographically
    # largest; remaining bits + 47 bytes = big-endian x.

    def to_compressed_bytes(self) -> bytes:
        if self.inf:
            return bytes([0xC0]) + bytes(47)
        b = bytearray(self.x.to_bytes(48, "big"))
        b[0] |= 0x80
        if self.y > (P - 1) // 2:
            b[0] |= 0x20
        return bytes(b)

    @classmethod
    def from_compressed_bytes_unchecked(cls, data: bytes) -> "G1":
        """Decode without the subgroup check (reference util.py:35-36).
        Still requires a well-formed encoding with x on the curve."""
        if native_enabled() and len(data) == 48:
            return _nat_decode(data, False)[0]
        return cls._oracle_decode(data, False)

    @classmethod
    def from_compressed_bytes(cls, data: bytes) -> "G1":
        """Checked decode: additionally verifies subgroup membership."""
        if native_enabled() and len(data) == 48:
            return _nat_decode(data, True)[0]
        return cls._oracle_decode(data, True)

    @classmethod
    def _oracle_decode(cls, data: bytes, check: bool) -> "G1":
        """The pure-Python decoder, the oracle of both decodes."""
        if len(data) != 48:
            raise ValueError(f"G1 compressed encoding must be 48 bytes, got {len(data)}")
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("uncompressed G1 encodings are not supported")
        if flags & 0x40:
            if flags & 0x20 or any(data[1:]) or (flags & 0x1F):
                raise ValueError("malformed infinity encoding")
            return cls.identity()
        x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
        if x >= P:
            raise ValueError("x coordinate not canonical")
        y = fq_sqrt((x * x % P * x + CURVE_B) % P)
        if y is None:
            raise ValueError("x is not on the curve")
        y_is_largest = y > (P - 1) // 2
        if bool(flags & 0x20) != y_is_largest:
            y = P - y
        p = cls(x, y)
        if check and not G1._from_jacobian(_jmul(p._jacobian(), FR_MOD)).inf:
            raise ValueError("point not in the prime-order subgroup")
        return p

    def __repr__(self) -> str:
        return f"G1({self.to_compressed_bytes().hex()})"


G1_GENERATOR = G1()
G1_IDENTITY = G1.identity()


# ---------------------------------------------------------------------------
# The native backend (csrc/g1_host.c): Montgomery-limb Fq, Jacobian G1,
# Pippenger MSM, batched serde, for the protocol's small batches; the large
# MSMs go to the card (ops.msm). The pure-Python code above stays the
# behavioural spec and the oracle. Which one runs is settled at the first
# call: the native one wherever the library is built or a C compiler can
# build it (host_native.available()), the oracle elsewhere and inside
# `oracle()`.
# ---------------------------------------------------------------------------

_native: Optional[bool] = None  # None until the first call settles it


def native_enabled() -> bool:
    """Whether the G1 methods and batch helpers take the native backend."""
    global _native
    if _native is None:
        _native = host_native.available()
    return _native


@contextlib.contextmanager
def oracle() -> Iterator[None]:
    """Run the block on the pure-Python oracle, the native backend off (for
    every thread: the switch is the module's)."""
    global _native
    prev = native_enabled()
    _native = False
    try:
        yield
    finally:
        _native = prev


def _enc96(p: G1) -> Tuple[bytes, int]:
    if p.inf:
        return b"\x00" * 96, 1
    return p.x.to_bytes(48, "big") + p.y.to_bytes(48, "big"), 0


def _enc_batch(points: List[G1]) -> Tuple[bytes, bytes]:
    return (
        b"".join(_enc96(p)[0] for p in points),
        bytes(1 if p.inf else 0 for p in points),
    )


def _dec96(b: bytes, inf: int) -> G1:
    if inf:
        return G1.identity()
    return G1(int.from_bytes(b[:48], "big"), int.from_bytes(b[48:96], "big"))


def _dec_batch(pb: bytes, ib: bytes) -> List[G1]:
    return [_dec96(pb[96 * i : 96 * i + 96], ib[i]) for i in range(len(ib))]


def _scalar_bytes(scalars: List[Fr]) -> bytes:
    return b"".join(s.v.to_bytes(32, "little") for s in scalars)


def _nat_add(a: G1, b: G1) -> G1:
    pa, ia = _enc96(a)
    pb, ib = _enc96(b)
    op, oi = host_native.g1_add_batch(pa, bytes([ia]), pb, bytes([ib]))
    return _dec96(op, oi[0])


def _nat_mul(p: G1, scalar: Fr) -> G1:
    pb, ib = _enc96(p)
    op, oi = host_native.g1_mul_batch(pb, bytes([ib]), scalar.v.to_bytes(32, "little"))
    return _dec96(op, oi[0])


def _reject(data: bytes, i: int, check: bool) -> None:
    """Raise the oracle's error for encoding i, which the native decoder
    refused: the messages are the oracle's, word for word."""
    G1._oracle_decode(data[48 * i : 48 * i + 48], check)
    raise AssertionError(f"the native decoder refused encoding {i}, which the oracle accepts")


def _nat_decode(data: bytes, check: bool) -> List[G1]:
    pb, ib, bad = host_native.g1_decompress_batch(data, check)
    if bad >= 0:
        _reject(data, bad, check)
    return _dec_batch(pb, ib)


def g1_sum(points: Iterable[G1]) -> G1:
    pts = list(points)
    if native_enabled() and len(pts) > 4:
        return _dec96(*host_native.g1_sum(*_enc_batch(pts)))
    acc = _JINF
    for p in pts:
        acc = _jadd(acc, p._jacobian())
    return G1._from_jacobian(acc)


def msm_host(bases: List[G1], scalars: List[Fr]) -> G1:
    """Exact host MSM (reference msm_accumulator.py:6-12 semantics): the
    native Pippenger, or the oracle's double-and-add; the oracle every device
    MSM is held against."""
    if len(bases) != len(scalars):
        raise ValueError("msm length mismatch")
    if native_enabled():
        pb, ib = _enc_batch(bases)
        return _dec96(*host_native.g1_msm(pb, ib, _scalar_bytes(scalars)))
    acc = _JINF
    for b, s in zip(bases, scalars):
        acc = _jadd(acc, _jmul(b._jacobian(), s.v))
    return G1._from_jacobian(acc)


def mul_host_batch(bases: List[G1], scalars: List[Fr]) -> List[G1]:
    """[b_i * s_i]: one native call for a whole vector of point muls."""
    if len(bases) != len(scalars):
        raise ValueError("mul_host_batch length mismatch")
    if native_enabled():
        pb, ib = _enc_batch(bases)
        return _dec_batch(*host_native.g1_mul_batch(pb, ib, _scalar_bytes(scalars)))
    return [b * s for b, s in zip(bases, scalars)]


def add_host_batch(a: List[G1], b: List[G1]) -> List[G1]:
    """[a_i + b_i] elementwise."""
    if len(a) != len(b):
        raise ValueError("add_host_batch length mismatch")
    if native_enabled():
        return _dec_batch(*host_native.g1_add_batch(*_enc_batch(a), *_enc_batch(b)))
    return [x + y for x, y in zip(a, b)]


def compress_host_batch(points: List[G1]) -> bytes:
    """Concatenated 48-byte compressed encodings."""
    if native_enabled():
        return host_native.g1_compress_batch(*_enc_batch(points))
    return b"".join(p.to_compressed_bytes() for p in points)


# From this many points an unchecked batch decode runs on the caller's device
# (ops.compress): one batched square-root chain for the whole batch.
DECOMPRESS_DEVICE_MIN = int(os.environ.get("CURDLEPROOFS_DECOMPRESS_DEVICE_MIN", str(1 << 13)))
# from this many points the native decode is split across host threads
_DECOMPRESS_THREADS_MIN = 2048


def decompress_host_batch(data: bytes, check: bool = False, device=None) -> List[G1]:
    """Decode len(data)/48 compressed points (ValueError on any bad one).

    An unchecked batch of at least DECOMPRESS_DEVICE_MIN points decodes on
    `device` (ops.compress; None is the card, and raises without one); every
    other batch on the host backend."""
    if len(data) % 48 != 0:
        raise ValueError("compressed batch length must be a multiple of 48")
    npts = len(data) // 48
    if not check and npts >= DECOMPRESS_DEVICE_MIN:
        from curdleproofs_tpu_torch.ops import compress as ocompress
        from curdleproofs_tpu_torch.utils.device import resolve_device
        from curdleproofs_tpu_torch.utils.errors import SerdeError

        dev = resolve_device(device)
        try:
            return ocompress.batch_decompress_to_host([data[48 * i : 48 * i + 48] for i in range(npts)], dev)
        except SerdeError as e:
            raise ValueError(str(e)) from e
    if native_enabled():
        nw = min(8, os.cpu_count() or 1)
        if npts >= _DECOMPRESS_THREADS_MIN and nw > 1:
            # the native call drops the interpreter lock and each point costs
            # a 381-bit square-root chain: split a big batch across threads
            step = -(-npts // nw) * 48
            chunks = [data[o : o + step] for o in range(0, len(data), step)]
            with ThreadPoolExecutor(max_workers=nw) as pool:
                outs = list(pool.map(lambda b: host_native.g1_decompress_batch(b, check), chunks))
            res: List[G1] = []
            for k, (pb, ib, bad) in enumerate(outs):
                if bad >= 0:
                    _reject(data, k * (step // 48) + bad, check)
                res.extend(_dec_batch(pb, ib))
            return res
        return _nat_decode(data, check)
    return [G1._oracle_decode(data[48 * i : 48 * i + 48], check) for i in range(npts)]
