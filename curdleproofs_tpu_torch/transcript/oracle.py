"""Fiat-Shamir oracle: Merlin-framed STROBE-128 with typed absorption.

One class covers what the reference splits across two layers — the Merlin
transcript framing (merlin_transcripts/merlin_transcript.py:6-24) and the
scalar-challenge adapter with rejection sampling
(curdleproofs/curdleproofs_transcript.py:15-28). The wire behaviour is
bit-exact with both; the API is shaped for this framework's vector types:
`absorb()` accepts points, scalars, byte strings, and whole PointVec /
ScalarVec batches (a PointVec is compressed with ONE native batch call
before framing, instead of a per-point Python loop).

Framing (Rust merlin crate v1.0):
    message m under label L:   meta_AD(L) ; meta_AD(len_le32, more) ; AD(m)
    challenge of n bytes:      meta_AD(L) ; meta_AD(n_le32, more)   ; PRF(n)

Fr challenges are drawn by rejection: 32 LE bytes, retried while the value
is zero or >= r, and the accepted bytes are absorbed back into the oracle —
the loop every cross-implementation proof byte depends on.

Backend: the native C duplex (csrc/keccak.c curdle_strobe_* /
curdle_merlin_* through utils.host_native — one C call per logical
operation, batch calls for vectors and multi-challenge draws) wherever the
package's host library can be built; the pure-Python Strobe128 otherwise.
Transcript replay is the dominant per-proof host cost of batched
verification once the MSMs are merged, which is why the whole framing layer
(not just the permutation) lives in C. Each Transcript settles its backend
when it is made: CURDLEPROOFS_TRANSCRIPT_NATIVE=0 forces the Python path
(the equivalence tests and the oracle run of chip_smoke.py use it).
"""
from __future__ import annotations

import os
from typing import Iterable, List, Union

from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.transcript.strobe import Strobe128
from curdleproofs_tpu_torch.utils import host_native as _KN


def native_enabled() -> bool:
    """Whether a Transcript made now takes the native duplex."""
    return os.environ.get("CURDLEPROOFS_TRANSCRIPT_NATIVE", "1") == "1" and _KN.available()

_LEN_BYTES = 4
_SCALAR_WIDTH = 32

Absorbable = Union[bytes, bytearray, Fr, "object"]


class Transcript:
    """Domain-separated Fiat-Shamir oracle over STROBE-128."""

    __slots__ = ("_duplex", "_buf", "_st")

    def __init__(self, domain: bytes) -> None:
        if native_enabled():
            self._duplex = None
            # the 203-byte duplex state and the ctypes view the C calls take
            self._buf = bytearray(_KN.STROBE_STATE_BYTES)
            self._st = _KN.strobe_state(self._buf)
            _KN.strobe_init(self._st, b"Merlin v1.0")
        else:
            self._duplex = Strobe128(b"Merlin v1.0")
            self._buf = self._st = None
        self._write(b"dom-sep", domain)

    # -- core framing ---------------------------------------------------------

    def _write(self, label: bytes, message: bytes) -> None:
        if self._st is not None:
            _KN.merlin_write(self._st, label, bytes(message))
            return
        d = self._duplex
        d.meta_ad(label, False)
        d.meta_ad(len(message).to_bytes(_LEN_BYTES, "little"), True)
        d.ad(message, False)

    def _read(self, label: bytes, n: int) -> bytes:
        if self._st is not None:
            return _KN.merlin_read(self._st, label, n)
        d = self._duplex
        d.meta_ad(label, False)
        d.meta_ad(n.to_bytes(_LEN_BYTES, "little"), True)
        return bytes(d.prf(n, False))

    # -- typed absorption -----------------------------------------------------

    def absorb(self, label: bytes, *items: Absorbable) -> None:
        """Absorb each item as its own framed message under `label`.

        Accepted item types: bytes, Fr, G1 (48-byte compressed), PointVec
        (batch-compressed once, then framed per point), ScalarVec, and
        iterables of any of these.
        """
        for item in items:
            self._absorb_one(label, item)

    def _absorb_one(self, label: bytes, item) -> None:
        if isinstance(item, (bytes, bytearray)):
            self._write(label, bytes(item))
        elif isinstance(item, Fr):
            self._write(label, item.to_le_bytes())
        elif hasattr(item, "compressed"):  # PointVec: one native batch encode
            encs = item.compressed()
            if self._st is not None:
                _KN.merlin_write_many(self._st, label, b"".join(encs), 48)
            else:
                for enc in encs:
                    self._write(label, enc)
        elif hasattr(item, "to_compressed_bytes"):  # single G1
            self._write(label, item.to_compressed_bytes())
        elif hasattr(item, "tolist"):  # ScalarVec
            if self._st is not None:
                blob = b"".join(f.to_le_bytes() for f in item.tolist())
                _KN.merlin_write_many(self._st, label, blob, 32)
            else:
                for f in item.tolist():
                    self._write(label, f.to_le_bytes())
        elif isinstance(item, Iterable):
            for sub in item:
                self._absorb_one(label, sub)
        else:
            raise TypeError(f"cannot absorb {type(item).__name__} into transcript")

    def absorb_u64(self, label: bytes, x: int) -> None:
        self._write(label, x.to_bytes(8, "little"))

    # -- challenges -----------------------------------------------------------

    def squeeze_bytes(self, label: bytes, n: int) -> bytes:
        return self._read(label, n)

    def scalar(self, label: bytes) -> Fr:
        """One uniform nonzero Fr challenge by rejection sampling; the
        accepted encoding is absorbed back (curdleproofs_transcript.py:17-25).
        """
        if self._st is not None:
            raw = _KN.merlin_challenge_scalars(self._st, label, 1)
            return Fr(int.from_bytes(raw, "little"))
        while True:
            raw = self._read(label, _SCALAR_WIDTH)
            v = int.from_bytes(raw, "little")
            if 0 < v < FR_MOD:
                self._write(label, raw)
                return Fr(v)

    def scalars(self, label: bytes, count: int) -> List[Fr]:
        if self._st is not None:
            raw = _KN.merlin_challenge_scalars(self._st, label, count)
            return [
                Fr(int.from_bytes(raw[32 * i : 32 * i + 32], "little"))
                for i in range(count)
            ]
        return [self.scalar(label) for _ in range(count)]

    # -- reference-compatible method aliases ----------------------------------
    # (MerlinTranscript: merlin_transcript.py:11-24; CurdleproofsTranscript:
    #  curdleproofs_transcript.py:8-28)

    append_message = _write
    append_u64 = absorb_u64
    challenge_bytes = _read
    append = _write

    def append_list(self, label: bytes, items) -> None:
        self.absorb(label, items)

    get_and_append_challenge = scalar
    get_and_append_challenges = scalars


# Compatibility names for the two reference-facing layers.
MerlinTranscript = Transcript
CurdleproofsTranscript = Transcript
