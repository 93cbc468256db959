"""BLS12-381 field constants and exact host-side scalar field arithmetic.

`Fr` is the protocol scalar type used by the host-side orchestration layer
(transcripts, challenges, serde, O(1) math). All O(n) field/point work runs on
the GPU via `curdleproofs_tpu_torch.ops`; this class is also the exactness
oracle those kernels are tested against. Pure Python, no tensor library.

Behaviour contract mirrors the reference's native `Scalar`
(py_arkworks_bls12381-stubs/__init__.pyi:32-54):
  * constructor accepts ints of any size, reduced mod r
  * from_le_bytes rejects values >= r; to_le_bytes is 32-byte little-endian
  * add/sub/mul/neg/square/pow/inverse/is_zero
"""
from __future__ import annotations

# Base field modulus (381 bits).
FQ_MOD = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
# Scalar field modulus r = order of the G1 subgroup (255 bits).
FR_MOD = int(
    "73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001",
    16,
)
CURVE_ORDER = FR_MOD

# BLS12-381 G1 generator affine coordinates (public standard constants).
G1_GEN_X = int(
    "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb",
    16,
)
G1_GEN_Y = int(
    "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
    "d03cc744a2888ae40caa232946c5e7e1",
    16,
)
# Curve equation y^2 = x^3 + 4.
CURVE_B = 4


class Fr:
    """Element of the BLS12-381 scalar field (exact, host-side)."""

    __slots__ = ("v",)
    MODULUS = FR_MOD

    def __init__(self, v: int = 0) -> None:
        self.v = v % FR_MOD

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other: "Fr") -> "Fr":
        return Fr(self.v + other.v)

    def __sub__(self, other: "Fr") -> "Fr":
        return Fr(self.v - other.v)

    def __mul__(self, other: "Fr") -> "Fr":
        return Fr(self.v * other.v)

    def __neg__(self) -> "Fr":
        return Fr(-self.v)

    def __pow__(self, n: int) -> "Fr":
        return Fr(pow(self.v, n, FR_MOD))

    def square(self) -> "Fr":
        return Fr(self.v * self.v)

    def inverse(self) -> "Fr":
        """Multiplicative inverse; Fr(0).inverse() raises ZeroDivisionError
        at use (matching the reference's invert() assert, util.py:51-54)."""
        if self.v == 0:
            raise ZeroDivisionError("inverse of zero Fr element")
        return Fr(pow(self.v, -1, FR_MOD))

    def is_zero(self) -> bool:
        return self.v == 0

    # -- comparisons / hashing ---------------------------------------------

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Fr):
            return NotImplemented
        return self.v == other.v

    def __hash__(self) -> int:
        return hash(("Fr", self.v))

    def __int__(self) -> int:
        return self.v

    def __repr__(self) -> str:
        return f"Fr({self.v:#x})"

    # -- serde (32-byte little-endian, reference util.py:39-44) -------------

    def to_le_bytes(self) -> bytes:
        return self.v.to_bytes(32, "little")

    @classmethod
    def from_le_bytes(cls, b: bytes) -> "Fr":
        if len(b) != 32:
            raise ValueError(f"Fr encoding must be 32 bytes, got {len(b)}")
        v = int.from_bytes(b, "little")
        if v >= FR_MOD:
            raise ValueError("Fr encoding not canonical (value >= r)")
        return cls(v)


ONE = Fr(1)
ZERO = Fr(0)


def fr_inner_product(a, b) -> Fr:
    """<a, b> over Fr lists (reference util.py:85-87)."""
    if len(a) != len(b):
        raise ValueError("inner_product length mismatch")
    acc = 0
    for x, y in zip(a, b):
        acc += x.v * y.v
    return Fr(acc)
