"""Limb-level field specifications and the tensor layout of the package.

Field elements are vectors of 16-bit limbs, **limb-major**: N elements have
shape (L, N) with the limb index leading and the batch trailing. Fq has 24
limbs, Fr has 16; the Montgomery radix is R = 2^(16*L). This is the layout of
the JAX package's arrays, kept 1:1 so the two compare limb for limb; the CUDA
kernels re-pair two 16-bit limbs into one 32-bit word in registers on load
(same R = 2^384, so values are unchanged).

Container: `torch.int32` holding values < 2^16 (torch's uint32 support on the
CPU is thin). `from_reference` / `to_reference` convert between the JAX
package's numpy views (uint32 limbs, bool masks, int32 index tables) and this
package's tensors.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from curdleproofs_tpu_torch.fields import FQ_MOD, FR_MOD
from curdleproofs_tpu_torch.utils.device import DeviceArg, resolve_device

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(v: int, nlimbs: int) -> np.ndarray:
    """Scalar int -> (L,) uint32 limb vector (little-endian limbs)."""
    return np.array(
        [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nlimbs)], dtype=np.uint32
    )


def ints_to_limbs(vals, nlimbs: int) -> np.ndarray:
    """List of ints -> (L, N) uint32, limb-major."""
    buf = b"".join(int(v).to_bytes(2 * nlimbs, "little") for v in vals)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(vals), nlimbs)
    return np.ascontiguousarray(arr.T).astype(np.uint32)


def limbs_to_ints(arr) -> list:
    """(L, N) or (L,) limb-major limbs (numpy or tensor) -> list of ints / int."""
    a = to_reference(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)
    single = a.ndim == 1
    if single:
        a = a[:, None]
    nlimbs, n = a.shape
    raw = np.ascontiguousarray(a.T.astype("<u2")).tobytes()
    step = 2 * nlimbs
    out = [int.from_bytes(raw[i * step : (i + 1) * step], "little") for i in range(n)]
    return out[0] if single else out


def from_reference(arr: np.ndarray, device: DeviceArg = None) -> torch.Tensor:
    """A numpy array in the JAX package's layout -> this package's tensor,
    1:1: uint32 limb arrays ((24, n) / (49, n) / (72, ...)) and int32 index
    tables -> torch.int32 of the same shape; bool masks -> torch.bool."""
    dev = resolve_device(device)
    a = np.asarray(arr)
    if a.dtype == np.bool_:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if a.dtype.kind == "u" and a.size and int(a.max()) > 0x7FFFFFFF:
        raise ValueError("value does not fit the int32 container")
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(dev)


def to_reference(t: torch.Tensor) -> np.ndarray:
    """This package's tensor -> numpy in the JAX package's layout: int32
    limb containers come back as uint32, bool stays bool."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.bool_:
        return a
    return a.astype(np.uint32)


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field in limb form."""

    name: str
    modulus: int
    nlimbs: int
    # derived, filled in __post_init__
    n0inv: int = field(init=False)
    r_mod: int = field(init=False)
    r2_mod: int = field(init=False)

    def __post_init__(self):
        radix = 1 << (LIMB_BITS * self.nlimbs)
        object.__setattr__(self, "n0inv", (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS))
        object.__setattr__(self, "r_mod", radix % self.modulus)
        object.__setattr__(self, "r2_mod", radix * radix % self.modulus)

    @functools.cached_property
    def mod_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.nlimbs)

    @functools.cached_property
    def one_mont(self) -> np.ndarray:
        return int_to_limbs(self.r_mod, self.nlimbs)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2_mod, self.nlimbs)

    def __hash__(self):
        return hash((self.name, self.modulus, self.nlimbs))


FQ_SPEC = FieldSpec("fq", FQ_MOD, 24)
FR_SPEC = FieldSpec("fr", FR_MOD, 16)
