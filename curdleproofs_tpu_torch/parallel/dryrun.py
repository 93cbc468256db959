"""The single-device entry and the multi-device dry run.

Counterpart of the JAX package's `__graft_entry__.entry`,
`dryrun_multichip` and `_dryrun_batched_2d`. `entry()` returns one
Pippenger window-partials step and its inputs. Every rank of the world
calls `dryrun_multichip(n)` (n = the world size): every sharded MSM on a
mesh of the whole world, at small sizes, against the exact host oracle; it
returns on every rank or raises on every rank that found a mismatch.
"""
from __future__ import annotations

import hashlib

import torch

from curdleproofs_tpu_torch.curve import G1, msm_host
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import msm as omsm
from curdleproofs_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d
from curdleproofs_tpu_torch.parallel.msm import (
    _all_gather,
    _horner,
    _window_sums_collective,
    msm_sharded,
    msm_sharded_ladder,
    msm_sharded_stream,
)
from curdleproofs_tpu_torch.utils.device import DeviceArg, resolve_device


def points_and_scalars(n: int, seed: int = 7):
    """Deterministic small test set: incremental multiples of G (cheap on the
    host) with pseudorandom scalars; the JAX package's, value for value."""
    pts = []
    acc = G1()
    g = G1()
    for _ in range(n):
        pts.append(acc)
        acc = acc + g
    scs = [
        Fr(int.from_bytes(hashlib.sha256(f"{seed}:{i}".encode()).digest(), "little") % FR_MOD)
        for i in range(n)
    ]
    return pts, scs


def entry(device: DeviceArg = None):
    """(forward, example_args): one Pippenger window-partials step at
    n = 1024 points and c = 8 bits, the JAX `entry()`'s shapes and inputs
    (`points_and_scalars(1024)`). The points are packed into the (49, n)
    stream records and the scalars into their (W, n) digits on `device` (the
    card unless the caller passes "cpu"); `forward(packed, digits)` returns
    the window total (Jacobian (24,)) and the bucket-weighted boundary sums
    (Jacobian (24, W)) of `ops.msm._window_partials`."""
    dev = resolve_device(device)
    n, c = 1024, 8
    pts, scs = points_and_scalars(n)
    packed = omsm._pack_records(og.pack_points(pts, dev))
    digits = omsm.extract_digits(og.pack_scalars(scs, dev), c)

    def forward(packed, digits):
        return omsm._window_partials(packed, digits, c)

    return forward, (packed, digits)


def dryrun_multichip(n_devices: int, device: DeviceArg = None) -> None:
    """Every sharded MSM over a mesh of n_devices ranks (the world size),
    checked against the host oracle; with at least 4 ranks, an even number,
    also the batched 2D layout (dp x sp)."""
    n = 32 * n_devices
    pts, scs = points_and_scalars(n)
    expect = msm_host(pts, scs)

    # 1D point-sharded MSM across all ranks; per-window partial sums combined
    # by the group all-reduce (all_gather + tree reduce)
    mesh = make_mesh(n_devices, device=device)
    if msm_sharded(pts, scs, mesh=mesh, c=4) != expect:
        raise AssertionError("sharded MSM result mismatch (1D mesh)")
    # the ladder sharding (one point a shard crosses)
    if msm_sharded_ladder(pts, scs, mesh=mesh) != expect:
        raise AssertionError("sharded ladder MSM result mismatch")
    # the streaming Pippenger sharded: per-shard host sort, gather, scan,
    # the collective window combine
    if msm_sharded_stream(pts, scs, mesh=mesh, c=4) != expect:
        raise AssertionError("sharded stream MSM result mismatch")

    # 2D mesh: dp (independent MSMs) x sp (points), the layout of batched
    # verification
    if n_devices >= 4 and n_devices % 2 == 0:
        _dryrun_batched_2d(make_mesh_2d((2, n_devices // 2), ("dp", "sp"), device=device))


def _dryrun_batched_2d(mesh: Mesh) -> None:
    """2*dp independent MSMs sharded dp x sp: the ranks of one dp row own two
    instances, each rank the sp block of their points. Each rank runs the
    sort engine's window partials on its blocks, the window sums meet over
    the sp group, and the results over the dp group, so every rank checks
    every instance against the oracle. (The JAX dry run pulls every shard's
    totals and boundary sums to its one host instead; a rank here holds
    only its own, so the combine over sp is the group all-reduce.)"""
    c = 4
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    local = 32
    n = local * sp
    batch = 2 * dp
    instances = [points_and_scalars(n, seed=100 + b) for b in range(batch)]
    W = -(-omsm.FR_BITS // c)
    o = mesh.coords["sp"] * local
    mine = []
    for b in range(2 * mesh.coords["dp"], 2 * mesh.coords["dp"] + 2):
        pts, scs = instances[b]
        packed = omsm._pack_records(og.pack_points(pts[o : o + local], mesh.device))
        digits = omsm.extract_digits(og.pack_scalars(scs[o : o + local], mesh.device), c)
        parts = [omsm._window_partials(packed, digits, c)]
        mine.append(_horner(_window_sums_collective(parts, c, mesh, "sp"), c, W))
    blob = b"".join(p.to_compressed_bytes() for p in mine)
    rows = _all_gather(torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(mesh.device), mesh.groups["dp"])
    got = []
    for r in rows:
        data = bytes(r.cpu().numpy())
        got += [G1.from_compressed_bytes_unchecked(data[48 * i : 48 * i + 48]) for i in range(2)]
    for b, (pts, scs) in enumerate(instances):
        if got[b] != msm_host(pts, scs):
            raise AssertionError(f"batched 2D sharded MSM mismatch (b={b})")
