"""Multi-device sharded MSM on torch.distributed.

Counterpart of the JAX package's `parallel/msm.py`. The points are sharded
along one axis of the mesh (parallel.mesh): every rank receives the same
full bases and scalars, as every host does under jax.distributed, and packs
and prepares only its own block [rank*local, (rank+1)*local), with the JAX
package's padding (local is the least power of two of at least 32 with
local*D >= n), so the shard boundaries are the JAX package's. Each rank runs
a whole local engine on its block and the window sums are combined by
linearity:

    S_w = sum_shards [ (B-1) * total_shard  -  bsum_{shard, w} ]

Each rank computes its contribution on its card, then the group all-reduce
(`_allreduce_group`: an all_gather of the Jacobian limbs, then an exact tree
reduce over the gathered axis on every rank; group addition is not integer
addition, so this, not an all_reduce, is the collective sum) leaves every
rank with the same window sums, and every rank returns the same G1 after the
host's Horner combine. The engines a shard runs are the port's own:

  * `msm_sharded`: the sort engine (`ops.msm._window_partials`: torch.sort,
    `gather_u32`, the prefix scan and the reduce over `point_op`);
  * `msm_sharded_ladder`: the GLV ladder (`ladder_glv_w3`) and a tree
    reduce; one Jacobian point a rank crosses the interconnect;
  * `msm_sharded_stream`: the streaming Pippenger, through the device loop
    `msm()` runs (`ops.msm.stream_prep`, `ops.msm._stream_chunks`): the scan
    with in-step boundary selection (`scan_sel`) on the GLV lanes from
    SEL_MIN_N lanes a rank, the complete full-prefix scan (`scan_full`) on
    the plain lanes below that and as the agreed redo.

Every rank must enter every collective in the same order or the world hangs.
The JAX package decides two things a shard and then acts for the mesh: a
selection-slot overflow and a doubling flag. Here each such decision is one
all_reduce (MAX) of a 0/1 flag, taken before any rank branches, so every
rank takes the plain path together or none does; and every rank walks the
same STREAM_SPLIT slices. With a gloo group the tensors cross through host
memory (gloo moves host tensors; it is (72, W) words here), with NCCL they
stay on the card; the kernels and the reduce run on the card either way.

Parts of the JAX sharded path that have no counterpart: the rebuild of
every shard's selection schedule at one common S (shard_map needs equal
shapes; the collective here carries (72, W) whatever S a rank used, so each
rank keeps its own), the index wire packing, the 4-window padded chunks and
the route solves on a pool (the direct gather, as in `msm()`).

Spans: `msm.sharded`, `msm.sharded_ladder`, `msm.sharded_stream` (a whole
call each), and within them `msm.sharded.pack` (this rank's block),
`msm.sharded.host_prep` (on the sel path with `.native` or `.numpy`
inside, as `msm()`'s), `msm.sharded.device` (ends in a synchronise),
`msm.sharded.collective` (the agreements and the group all-reduce, ends in
a synchronise) and `msm.sharded.combine` (readback and Horner); the stream
engine also records `msm.sharded.sel` and `msm.sharded.plain`, one a run of
each path.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import Fr
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import glv as oglv
from curdleproofs_tpu_torch.ops import msm as omsm
from curdleproofs_tpu_torch.ops import scan as oscan
from curdleproofs_tpu_torch.ops import stream_scan as ostream
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, ints_to_limbs, to_reference
from curdleproofs_tpu_torch.ops.g1 import JPoints
from curdleproofs_tpu_torch.parallel.mesh import Mesh, make_mesh
from curdleproofs_tpu_torch.utils.device import DeviceArg
from curdleproofs_tpu_torch.utils.profiling import timed

FR_BITS = omsm.FR_BITS


def _mul_pow2m1(p: JPoints, c: int) -> JPoints:
    """(2^c - 1) * P on the device: c doublings and one subtraction."""
    acc = p
    for _ in range(c):
        acc = og.jdbl(acc)
    return og.jadd(acc, og.jneg(p))


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's t in the group's rank order (t alone without a group).
    A gloo group moves host tensors, so a CUDA tensor crosses through host
    memory there and comes back to its card."""
    if group is None:
        return [t]
    via_host = t.is_cuda and dist.get_backend(group) == "gloo"
    send = (t.cpu() if via_host else t).contiguous()
    out = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, send, group=group)
    return [o.to(t.device) for o in out] if via_host else out


def _allreduce_group(p: JPoints, group) -> JPoints:
    """Group-element all-reduce over a mesh axis: all_gather the Jacobian
    limbs, then tree-reduce the gathered axis with exact group adds on every
    rank (the same result on each)."""
    t = torch.cat([p.x, p.y, p.z], dim=0)  # (72, ...)
    g = torch.stack(_all_gather(t, group), dim=-1)  # (72, ..., D)
    return oscan.tree_reduce_hybrid(JPoints(g[:24], g[24:48], g[48:]))


def _agree(flag: bool, mesh: Mesh, axis: str) -> bool:
    """True on every rank of the axis when `flag` holds on any: one
    all_reduce (MAX) of a 0/1 flag, which every rank enters before any
    branches on it."""
    group = mesh.groups[axis]
    if group is None:
        return flag
    on_card = dist.get_backend(group) == "nccl"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device if on_card else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def _local_window_sums(parts, c: int) -> JPoints:
    """This rank's window contributions (B-1)*total - bsums_w, (24, W), from
    the engine's chunks [(total (24,), bsums (24, wb), ...)]: each chunk's
    bsums with its own total, as the JAX package's per-chunk collective
    does. All chunks' (2^c - 1)*total in one go."""
    totals = JPoints(*(torch.stack([p[0][k] for p in parts], dim=1) for k in range(3)))  # (24, chunks)
    big = _mul_pow2m1(totals, c)
    widths = [p[1].x.shape[-1] for p in parts]
    big_w = JPoints(*(torch.cat([a[:, k : k + 1].expand(-1, w) for k, w in enumerate(widths)], dim=1) for a in big))
    bsums = JPoints(*(torch.cat([p[1][k] for p in parts], dim=1) for k in range(3)))
    return og.jadd(big_w, og.jneg(bsums))


def _window_sums_collective(parts, c: int, mesh: Mesh, axis: str) -> JPoints:
    """Every rank's chunks -> the window sums S_w (24, W), the same on every
    rank of the axis."""
    return _allreduce_group(_local_window_sums(parts, c), mesh.groups[axis])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _to_host(p: JPoints) -> List[G1]:
    """(24, k) Jacobian points on the device -> k host G1, one readback."""
    arr = to_reference(torch.cat([p.x, p.y, p.z], dim=0))
    return og.jpoints_to_host(JPoints(arr[:24], arr[24:48], arr[48:]))


def _horner(wins: JPoints, c: int, W: int) -> G1:
    """Read the window sums back and combine them on the host:
    sum_w 2^{cw} S_w."""
    pts = _to_host(wins)[:W]
    acc = G1.identity()
    for w in reversed(range(W)):
        for _ in range(c):
            acc = acc + acc
        acc = acc + pts[w]
    return acc


def _collect(wins_local: JPoints, c: int, W: int, mesh: Mesh, axis: str) -> G1:
    """The group all-reduce of this rank's window contributions, then the
    host combine."""
    with timed("msm.sharded.collective"):
        wins = _allreduce_group(wins_local, mesh.groups[axis])
        _sync(mesh.device)
    with timed("msm.sharded.combine"):
        return _horner(wins, c, W)


def _local_width(n: int, D: int, floor: int) -> int:
    local = floor
    while local * D < n:
        local *= 2
    return local


def _own_block(bases, scalars, mesh: Mesh, axis: str, local: int):
    """This rank's block of the inputs, padded with identity bases and zero
    scalars: packed points on the rank's device and (16, local) scalar limbs
    as host numpy."""
    o = mesh.coords[axis] * local
    pts = list(bases[o : o + local])
    scs = list(scalars[o : o + local])
    pad = local - len(pts)
    with timed("msm.sharded.pack"):
        points = og.pack_points(pts + [G1.identity()] * pad, mesh.device)
        sc = np.asarray(ints_to_limbs([s.v for s in scs] + [0] * pad, 16), dtype=np.uint32)
    return points, sc


def _setup(bases, scalars, mesh: Optional[Mesh], device: DeviceArg) -> Mesh:
    if len(bases) != len(scalars):
        raise ValueError("msm length mismatch")
    return mesh if mesh is not None else make_mesh(device=device)


def msm_sharded(
    bases: Sequence[G1],
    scalars: Sequence[Fr],
    mesh: Optional[Mesh] = None,
    c: Optional[int] = None,
    window_batch: Optional[int] = None,
    point_axis: str = "shard",
    device: DeviceArg = None,
) -> G1:
    """MSM with the point dimension sharded across the mesh, each shard on
    the sort engine. mesh defaults to `make_mesh(device=device)`."""
    mesh = _setup(bases, scalars, mesh, device)
    if not bases:
        return G1.identity()
    D = mesh.shape[point_axis]
    n = len(bases)
    local = _local_width(n, D, 32)
    with timed("msm.sharded", items=n):
        points, sc = _own_block(bases, scalars, mesh, point_axis, local)
        c = c or omsm.pick_window(local)
        W = -(-FR_BITS // c)
        if window_batch is None:
            window_batch = max(1, min(W, (1 << 21) // local))
        with timed("msm.sharded.device"):
            digits = omsm.extract_digits(from_reference(sc, mesh.device), c)  # (W, local)
            packed = omsm._pack_records(points)
            parts = [
                omsm._window_partials(packed, digits[w0 : w0 + window_batch].contiguous(), c)
                for w0 in range(0, W, window_batch)
            ]
            wins = _local_window_sums(parts, c)
            _sync(mesh.device)
        return _collect(wins, c, W, mesh, point_axis)


def msm_sharded_ladder(
    bases: Sequence[G1],
    scalars: Sequence[Fr],
    mesh: Optional[Mesh] = None,
    point_axis: str = "shard",
    device: DeviceArg = None,
) -> G1:
    """Point-sharded MSM over the GLV ladder: each shard runs the ladder and
    a tree reduce on its block, and exactly one Jacobian point a shard
    crosses the interconnect. The JAX package pads a shard to at least 128
    lanes, a Pallas tile; here to 32, like the other engines (the same point
    either way)."""
    mesh = _setup(bases, scalars, mesh, device)
    if not bases:
        return G1.identity()
    D = mesh.shape[point_axis]
    n = len(bases)
    local = _local_width(n, D, 32)
    with timed("msm.sharded_ladder", items=n):
        points, sc = _own_block(bases, scalars, mesh, point_axis, local)
        with timed("msm.sharded.host_prep"):
            s1, neg1, s2 = oglv.decompose(sc.astype(np.uint64))
            halves = np.concatenate([s1, s2, neg1[None].astype(np.uint32)], axis=0)  # (19, local)
        with timed("msm.sharded.device"):
            up = from_reference(halves, mesh.device)
            acc = og.scalar_mul_glv(points, up[:9], up[18], up[9:18])
            r = oscan.tree_reduce_hybrid(acc)  # (24,)
            one = JPoints(r.x[:, None], r.y[:, None], r.z[:, None])
            _sync(mesh.device)
        with timed("msm.sharded.collective"):
            g = _allreduce_group(one, mesh.groups[point_axis])  # (24, 1), the same on every rank
            _sync(mesh.device)
        with timed("msm.sharded.combine"):
            return _to_host(g)[0]


def msm_sharded_stream(
    bases: Sequence[G1],
    scalars: Sequence[Fr],
    mesh: Optional[Mesh] = None,
    c: Optional[int] = None,
    point_axis: str = "shard",
    device: DeviceArg = None,
) -> G1:
    """Point-sharded streaming Pippenger. Every shard runs the device loop of
    `msm()` on its block: from SEL_MIN_N GLV lanes a shard the scan with
    in-step boundary selection, below that
    the complete full-prefix scan, which is also where every rank goes
    together after a selection-slot overflow or a doubling flag on any
    rank. Inputs wider than D * STREAM_SPLIT run as slices of that width,
    added on the host, on every rank alike."""
    mesh = _setup(bases, scalars, mesh, device)
    if not bases:
        return G1.identity()
    D = mesh.shape[point_axis]
    n = len(bases)
    if omsm.STREAM_SPLIT and n > D * omsm.STREAM_SPLIT:
        step = D * omsm.STREAM_SPLIT
        acc = G1.identity()
        for o in range(0, n, step):
            acc = acc + msm_sharded_stream(
                bases[o : o + step], scalars[o : o + step], mesh=mesh, point_axis=point_axis
            )
        return acc
    local = _local_width(n, D, 32)
    with timed("msm.sharded_stream", items=n):
        points, sc = _own_block(bases, scalars, mesh, point_axis, local)
        c = c or omsm.pick_window(n)
        if omsm.STREAM_GLV and 2 * local >= omsm.SEL_MIN_N:
            res = _sharded_stream_sel(points, sc, mesh, point_axis, local, c)
            if res is not None:
                return res
        return _sharded_stream_plain(points, sc, mesh, point_axis, local, c)


def _sharded_stream_sel(points, sc, mesh: Mesh, axis: str, local: int, c: int) -> Optional[G1]:
    """The production path: GLV lanes, the host prep `msm()` runs
    (`ops.msm.stream_prep`: native where the library is built, numpy
    otherwise), the scan with in-step boundary selection. Returns None, on
    every rank, when any rank's boundaries overflow the selection slots, and
    reruns the plain path itself, on every rank, when any rank's scan raised
    a doubling flag."""
    n2 = 2 * local
    L = ostream.pick_lanes(n2)
    T = n2 // L
    with timed("msm.sharded.sel"):
        with timed("msm.sharded.host_prep"):
            neg1, order_cm, bidx, lidx, sel, bpos, S = omsm.stream_prep(
                sc, c, L, glv_split=True, want_sel=True, span="msm.sharded.host_prep"
            )
        with timed("msm.sharded.collective"):
            if _agree(sel is None, mesh, axis):
                return None
        # each rank keeps its own S: the collective carries (72, W) whatever
        # S a rank scheduled (the JAX package rebuilds every shard's schedule
        # at one S because shard_map needs equal shapes)
        W = order_cm.shape[0]
        with timed("msm.sharded.device"):
            packed = omsm._glv_stream_packed(
                points.x, points.y, points.inf, from_reference(neg1, mesh.device)
            ).contiguous()
            parts = omsm._stream_chunks(
                packed, order_cm, bidx, lidx, sel, bpos, S, T, L, max(1, min(W, (1 << 22) // n2))
            )
            wins = _local_window_sums(parts, c)
            flagged = bool(torch.cat([p[2] for p in parts]).any())
        with timed("msm.sharded.collective"):
            redo = _agree(flagged, mesh, axis)
        if not redo:
            return _collect(wins, c, W, mesh, axis)
    # a p == q collision hit some rank's no-doubling scan: every rank redoes
    # its block on the complete scan
    return _sharded_stream_plain(points, sc, mesh, axis, local, c)


def _sharded_stream_plain(points, sc, mesh: Mesh, axis: str, local: int, c: int) -> G1:
    """The doubling-safe path: no GLV split (W = ceil(255/c)), the numpy host
    prep of this rank's block, the complete full-prefix scan; the small-size
    path and the agreed redo. The JAX package's plain sharded path, window
    for window."""
    W = -(-FR_BITS // c)
    L = ostream.pick_lanes(local)
    T = local // L
    with timed("msm.sharded.plain"):
        with timed("msm.sharded.host_prep"):
            order_cm, bidx, lidx, _ = omsm.stream_host_prep(omsm.host_digits(sc, c), c, L)
        with timed("msm.sharded.device"):
            packed = omsm._pack_records(points)
            parts = omsm._stream_chunks(
                packed, order_cm, bidx, lidx, None, None, 0, T, L, max(1, min(W, (1 << 22) // local))
            )
            wins = _local_window_sums(parts, c)
            _sync(mesh.device)
        return _collect(wins, c, W, mesh, axis)
