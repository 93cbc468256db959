"""The Fiat-Shamir transcript: Keccak-f[1600], STROBE-128 and the Merlin
framing, bit-exact with the Rust merlin crate."""
from curdleproofs_tpu_torch.transcript.keccak import keccak_f1600
from curdleproofs_tpu_torch.transcript.strobe import Strobe128
from curdleproofs_tpu_torch.transcript.oracle import (
    CurdleproofsTranscript,
    MerlinTranscript,
    Transcript,
)

__all__ = [
    "keccak_f1600",
    "Strobe128",
    "Transcript",
    "MerlinTranscript",
    "CurdleproofsTranscript",
]
