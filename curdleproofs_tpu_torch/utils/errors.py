"""Structured error types.

The reference signals failure with bare `assert`/`raise Exception`
(e.g. ipa.py:90-93, curdleproofs.py:176-177) and converts to bool only at the
Whisk API (whisk_interface.py:83-87). We keep that outward behaviour but use
typed exceptions so callers can distinguish malformed inputs from failed
cryptographic checks."""


class ProofError(Exception):
    """Base class for all curdleproofs errors."""


class SerdeError(ProofError, ValueError):
    """Malformed encoding (bad point/scalar bytes, truncated buffer)."""


class InvalidInputError(ProofError, ValueError):
    """Structurally invalid statement or parameters (sizes, powers of two)."""


class VerificationError(ProofError, AssertionError):
    """A cryptographic check failed during verification."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise VerificationError(msg)
