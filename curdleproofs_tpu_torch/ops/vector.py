"""Host-facing batched point-vector operations.

Counterpart of the JAX package's `ops.vector`. The protocol layer works with
exact host `G1` / `Fr` objects; every O(n) point operation comes here, where
the vectors are packed into limb tensors, processed on the device and
unpacked:

  * fold_points, fold_points_multi — the Bulletproofs-style fold rounds
  * scale_points, scale_points_common — basis rescaling, tracker
    re-randomisation
  * add_points — elementwise sums

The scalar multiplications go through `ops.g1.scalar_mul` (on the card: six
launches of the point kernel for the table, one `ladder_w3` launch), the adds
through `ops.g1.jmadd` (the point kernel). The JAX package pads every vector
to a power of two of at least 128 so that each width compiles once; nothing
is compiled per shape here and the kernels mask their ragged last block, so
the vectors go in at their own length.

Every function runs on the GPU unless the caller passes device="cpu" (the
plain PyTorch versions); with no CUDA device and no explicit "cpu" it raises.
"""
from __future__ import annotations

from typing import List, Sequence

from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import Fr
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.utils.device import DeviceArg, resolve_device


def scale_points(points: Sequence[G1], scalars: Sequence[Fr], device: DeviceArg = None) -> List[G1]:
    """[P_i * s_i] with per-point scalars, batched on the device."""
    dev = resolve_device(device)
    if len(points) != len(scalars):
        raise ValueError("scale_points length mismatch")
    if not points:
        return []
    res = og.scalar_mul(og.pack_points(list(points), dev), og.pack_scalars(list(scalars), dev))
    return og.jpoints_to_host(res)


def scale_points_common(points: Sequence[G1], k: Fr, device: DeviceArg = None) -> List[G1]:
    """[P_i * k] with one common scalar (tracker re-randomisation)."""
    return scale_points(points, [k] * len(points), device)


def _fold(a: Sequence[G1], b: Sequence[G1], gammas: Sequence[Fr], dev) -> List[G1]:
    gb = og.scalar_mul(og.pack_points(list(b), dev), og.pack_scalars(list(gammas), dev))
    return og.jpoints_to_host(og.jmadd(gb, og.pack_points(list(a), dev)))


def fold_points(a: Sequence[G1], b: Sequence[G1], gamma: Fr, device: DeviceArg = None) -> List[G1]:
    """[a_i + gamma * b_i]: the fold round primitive."""
    dev = resolve_device(device)
    if len(a) != len(b):
        raise ValueError("fold_points length mismatch")
    if not a:
        return []
    return _fold(a, b, [gamma] * len(a), dev)


def fold_points_multi(
    a: Sequence[G1], b: Sequence[G1], gammas: Sequence[Fr], device: DeviceArg = None
) -> List[G1]:
    """[a_i + gammas_i * b_i]: fold with PER-ELEMENT scalars. Used by the
    lockstep batch prover, where K proofs' fold rounds merge into one
    dispatch and each segment carries its own challenge."""
    dev = resolve_device(device)
    if len(a) != len(b) or len(a) != len(gammas):
        raise ValueError("fold_points_multi length mismatch")
    if not a:
        return []
    return _fold(a, b, gammas, dev)


def add_points(a: Sequence[G1], b: Sequence[G1], device: DeviceArg = None) -> List[G1]:
    """[a_i + b_i] elementwise."""
    dev = resolve_device(device)
    if len(a) != len(b):
        raise ValueError("add_points length mismatch")
    if not a:
        return []
    res = og.jmadd(og.lift(og.pack_points(list(a), dev)), og.pack_points(list(b), dev))
    return og.jpoints_to_host(res)
