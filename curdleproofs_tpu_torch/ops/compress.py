"""Batched G1 point compression and decompression on the device.

Counterpart of the JAX package's `ops.compress`. The batched Whisk verifier
decodes 4*ell tracker points per proof (48-byte ZCash compressed each;
whisk_interface.py:96-100), K proofs in one batch. On the host each point
costs a 381-bit square-root exponentiation; here the whole batch parses its
flag bytes on the host (cheap byte work), then runs one batched chain on the
device: y^2 = x^3 + 4, y = (y^2)^((p+1)/4), the check that the root squares
back, and the lexicographic sign fix.

The JAX package jits that chain into one XLA program. Here
`_decompress_device` and `_compress_device` dispatch on the tensor's device:
a CUDA tensor goes to one launch of a CUDA kernel (`cuda_g1.decompress` /
`cuda_g1.compress`, csrc/field_kernels.cu), a CPU tensor to the plain
PyTorch chain on `ops.modarith` (`_decompress_plain` / `_compress_plain`),
which the tests hold against the JAX package and the card's kernels against.
`curve.decompress_host_batch` routes an unchecked batch here from
DECOMPRESS_DEVICE_MIN points.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FQ_MOD
from curdleproofs_tpu_torch.ops import cuda_g1
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import modarith as ma
from curdleproofs_tpu_torch.ops.fieldspec import FQ_SPEC, from_reference, ints_to_limbs, limbs_to_ints, to_reference
from curdleproofs_tpu_torch.utils.device import DeviceArg, resolve_device
from curdleproofs_tpu_torch.utils.errors import SerdeError
from curdleproofs_tpu_torch.utils.profiling import timed

_P34 = (FQ_MOD + 1) // 4  # sqrt exponent (p ≡ 3 mod 4)
_HALF = (FQ_MOD - 1) // 2
_HALF_P1 = _HALF + 1  # compare y > (p-1)/2 via y - (half+1) borrow


def _to_mont(a: torch.Tensor) -> torch.Tensor:
    return ma.mont_mul(FQ_SPEC, a, ma._col(FQ_SPEC.r2_limbs, a).expand_as(a))


def _from_mont(a: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(a)
    one[0] = 1
    return ma.mont_mul(FQ_SPEC, a, one)


def _is_largest(y_can: torch.Tensor) -> torch.Tensor:
    """canonical y > (p-1)/2, i.e. no borrow out of y - ((p-1)/2 + 1)."""
    half_p1 = ma._col(ints_to_limbs([_HALF_P1], FQ_SPEC.nlimbs)[:, 0], y_can, torch.int64)
    _, borrow = ma._sub_borrow(y_can.to(torch.int64), half_p1.expand(y_can.shape))
    return borrow == 0


def _decompress_device(x_limbs: torch.Tensor, sign_largest: torch.Tensor):
    """x (24, n) canonical, sign flags (n,) bool -> (x_m, y_m (Montgomery),
    ok mask) with y chosen by the lexicographic-largest flag: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if x_limbs.is_cuda:
        return cuda_g1.decompress(x_limbs, sign_largest)
    return _decompress_plain(x_limbs, sign_largest)


def _decompress_plain(x_limbs: torch.Tensor, sign_largest: torch.Tensor):
    """The plain version of `_decompress_device`, on `ops.modarith`."""
    xm = _to_mont(x_limbs)
    x3 = ma.mont_mul(FQ_SPEC, ma.mont_sqr(FQ_SPEC, xm), xm)
    four = torch.zeros_like(x_limbs)
    four[0] = 4
    rhs = ma.add(FQ_SPEC, x3, _to_mont(four))  # y^2 = x^3 + 4
    y = ma.mont_pow_const(FQ_SPEC, rhs, _P34)
    ok = ma.eq(FQ_SPEC, ma.mont_sqr(FQ_SPEC, y), rhs)  # the root existed
    flip = _is_largest(_from_mont(y)) != sign_largest
    return xm, ma.select(flip, ma.neg(FQ_SPEC, y), y), ok


def parse_encodings(encodings: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host parse of a batch of 48-byte compressed points: x limbs (24, n)
    canonical (0 for infinity), the lexicographic-largest flags (n,) and the
    infinity flags (n,). Raises SerdeError on malformed flag bytes or a
    non-canonical x, as the host decoder does; whether x has a root is the
    device's check."""
    n = len(encodings)
    xs: List[int] = []
    signs = np.zeros(n, dtype=bool)
    infs = np.zeros(n, dtype=bool)
    for i, data in enumerate(encodings):
        if len(data) != 48:
            raise SerdeError(f"encoding {i}: need 48 bytes, got {len(data)}")
        flags = data[0]
        if not flags & 0x80:
            raise SerdeError(f"encoding {i}: uncompressed form not supported")
        if flags & 0x40:
            if flags & 0x20 or any(data[1:]) or (flags & 0x1F):
                raise SerdeError(f"encoding {i}: malformed infinity")
            infs[i] = True
            xs.append(0)
            continue
        x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
        if x >= FQ_MOD:
            raise SerdeError(f"encoding {i}: x not canonical")
        xs.append(x)
        signs[i] = bool(flags & 0x20)
    return ints_to_limbs(xs, FQ_SPEC.nlimbs), signs, infs


def batch_decompress(encodings: Sequence[bytes], device: DeviceArg = None) -> Tuple[og.APoints, List[bool]]:
    """Decode a batch of 48-byte compressed points on `device` (unchecked: no
    subgroup test, matching reference util.py:35-36). Raises SerdeError on
    malformed flag bytes, a non-canonical x or a non-residue, as the host
    decoder does."""
    dev = resolve_device(device)
    n = len(encodings)
    with timed("decompress.parse", items=n):
        x, signs, infs = parse_encodings(encodings)
    with timed("decompress.upload", items=n):
        x_limbs = from_reference(x, dev)
        sign_d = from_reference(signs, dev)
    with timed("decompress.device", items=n):  # the chain, then the readback of ok
        xm, ym, ok = _decompress_device(x_limbs, sign_d)
        ok_host = to_reference(ok) | infs
    if not ok_host.all():
        bad = int(np.argmin(ok_host))
        raise SerdeError(f"encoding {bad}: x is not on the curve")
    return og.APoints(xm, ym, from_reference(infs, dev)), [bool(b) for b in infs]


def batch_decompress_to_host(encodings: Sequence[bytes], device: DeviceArg = None) -> List[G1]:
    """Batched decode straight to host G1 points."""
    ap, _ = batch_decompress(encodings, device)
    with timed("decompress.unpack", items=len(encodings)):
        return og.unpack_points(ap)


def _compress_device(p: og.APoints):
    """Affine points -> (x canonical (24, n), y > (p-1)/2 (n,)): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if p.x.is_cuda:
        x, y = p.x.reshape(24, -1), p.y.reshape(24, -1)
        xc, largest = cuda_g1.compress(x, y)
        return xc.reshape(p.x.shape), largest.reshape(p.x.shape[1:])
    return _compress_plain(p)


def _compress_plain(p: og.APoints):
    """The plain version of `_compress_device`, on `ops.modarith`."""
    return _from_mont(p.x), _is_largest(_from_mont(p.y))


def batch_compress(p: og.APoints) -> List[bytes]:
    """Batched 48-byte ZCash compressed encoding of affine device points (on
    the device they lie on)."""
    x_can, largest = _compress_device(p)
    xs = limbs_to_ints(x_can)
    if isinstance(xs, int):
        xs = [xs]
    infs = np.atleast_1d(to_reference(p.inf))
    largest = np.atleast_1d(to_reference(largest))
    out = []
    for x, inf, lg in zip(xs, infs, largest):
        if inf:
            out.append(bytes([0xC0]) + bytes(47))
            continue
        b = bytearray(int(x).to_bytes(48, "big"))
        b[0] |= 0x80
        if lg:
            b[0] |= 0x20
        out.append(bytes(b))
    return out
