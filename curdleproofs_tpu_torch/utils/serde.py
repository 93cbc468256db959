"""Byte/JSON serialization helpers and the sequential buffer reader.

Wire formats are byte-identical to the reference: G1 points are 48-byte ZCash
compressed (decoded unchecked on read — reference util.py:35-36,143-147), Fr
scalars are 32-byte little-endian canonical (util.py:149-153). JSON uses hex
strings of the same encodings (util.py:99-116)."""
from __future__ import annotations

from typing import List

from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import Fr
from curdleproofs_tpu_torch.utils.errors import SerdeError


class BufReader:
    """Fixed-layout sequential reader over proof bytes."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.ptr = 0

    def _take(self, n: int) -> bytes:
        end = self.ptr + n
        if end > len(self.data):
            raise SerdeError(
                f"buffer underrun: need {n} bytes at offset {self.ptr}, "
                f"have {len(self.data) - self.ptr}"
            )
        out = self.data[self.ptr : end]
        self.ptr = end
        return out

    def read_g1(self) -> G1:
        try:
            return G1.from_compressed_bytes_unchecked(self._take(48))
        except ValueError as e:
            raise SerdeError(str(e)) from e

    def read_fr(self) -> Fr:
        try:
            return Fr.from_le_bytes(self._take(32))
        except ValueError as e:
            raise SerdeError(str(e)) from e

    def done(self) -> bool:
        return self.ptr == len(self.data)


def g1_to_bytes(p: G1) -> bytes:
    return p.to_compressed_bytes()


def g1_list_to_bytes(ps: List[G1]) -> bytes:
    return b"".join(p.to_compressed_bytes() for p in ps)


def fr_to_bytes(f: Fr) -> bytes:
    return f.to_le_bytes()


def g1_to_json(p: G1) -> str:
    return p.to_compressed_bytes().hex()


def g1_from_json(s: str) -> G1:
    return G1.from_compressed_bytes_unchecked(bytes.fromhex(s))


def fr_to_json(f: Fr) -> str:
    return f.to_le_bytes().hex()


def fr_from_json(s: str) -> Fr:
    return Fr.from_le_bytes(bytes.fromhex(s))


def points_to_transcript_bytes(ps: List[G1]) -> List[bytes]:
    return [p.to_compressed_bytes() for p in ps]


def log2_int(x: int) -> int:
    lg = x.bit_length() - 1
    if x <= 0 or (1 << lg) != x:
        raise SerdeError(f"{x} is not a power of two")
    return lg
