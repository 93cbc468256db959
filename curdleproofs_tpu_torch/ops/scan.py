"""Batched group reductions and prefix scans over point vectors.

The MSM engines (ops.msm) need three collective primitives over Jacobian
point vectors, all built purely from complete group adds (`g1.jadd`, which
is the CUDA point kernel on the card):

  * `_hs_scan`: fixed-width Hillis-Steele inclusive scan (the lane-offset
    stitch over the L scan lanes of the streaming MSM)
  * `tree_reduce_hybrid`: sum N points -> 1 (the bucket-boundary reduce)
  * `inclusive_scan`: P_j = p_0 + ... + p_j for all j, Blelloch-style, about
    2N adds (the prefix of the sort-based Pippenger engines): pair sums and
    recursion while the vector is wider than SMALL_WIDTH, `_hs_scan` below
  * `inclusive_scan_records`: the same scan from gathered point records to
    one (72, wb, n) prefix table. On the card it is a level schedule
    (`scan_schedule`): one launch of the strided point kernel a level or
    step, each reading and writing its operands by offset and stride, with
    no copy between launches; on the CPU it is `lift`, `inclusive_scan` and
    a concatenation. `inclusive_scan_levels_ref` runs the schedule with the
    plain formulas.

The order of the adds is the JAX package's (`ops.scan`), so the Jacobian
representatives, not only the points, come out identical: halve by adding the
upper half onto the lower while the vector is wider than SMALL_WIDTH, then
finish with log-step shifted adds at fixed width.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from curdleproofs_tpu_torch.ops.g1 import APoints, JPoints, _jadd_formulas, jadd, jinf, jselect, lift

SMALL_WIDTH = 2048


def _roll(p: JPoints, shift: int) -> JPoints:
    return JPoints(
        torch.roll(p.x, shift, dims=-1),
        torch.roll(p.y, shift, dims=-1),
        torch.roll(p.z, shift, dims=-1),
    )


def _interleave(a: JPoints, b: JPoints) -> JPoints:
    """[a0, b0, a1, b1, ...] along the last axis."""

    def go(x, y):
        return torch.stack([x, y], dim=-1).reshape(x.shape[:-1] + (2 * x.shape[-1],))

    return JPoints(go(a.x, b.x), go(a.y, b.y), go(a.z, b.z))


def _split_even_odd(p: JPoints):
    ev = JPoints(p.x[..., 0::2], p.y[..., 0::2], p.z[..., 0::2])
    od = JPoints(p.x[..., 1::2], p.y[..., 1::2], p.z[..., 1::2])
    return ev, od


def _shift_in_inf(p: JPoints) -> JPoints:
    """Shift right by one along the last axis, shifting in infinity."""
    pad = jinf(p.x.shape[1:-1] + (1,), device=p.x.device)
    return JPoints(
        torch.cat([pad.x, p.x[..., :-1]], dim=-1),
        torch.cat([pad.y, p.y[..., :-1]], dim=-1),
        torch.cat([pad.z, p.z[..., :-1]], dim=-1),
    )


def _hs_scan(p: JPoints) -> JPoints:
    """Hillis-Steele inclusive scan along the last axis at fixed width."""
    n = p.x.shape[-1]
    steps = max(1, (n - 1).bit_length())
    idx = torch.arange(n, device=p.x.device)
    inf = jinf(p.x.shape[1:], device=p.x.device)
    for s in range(steps):
        d = 1 << s
        rolled = jselect(idx >= d, _roll(p, d), inf)
        p = jadd(p, rolled)
    return p


def _hs_reduce(p: JPoints) -> JPoints:
    """Reduce a fixed-width vector to lane 0 via log-step shifted adds."""
    n = p.x.shape[-1]
    steps = (n - 1).bit_length()
    idx = torch.arange(n, device=p.x.device)
    inf = jinf(p.x.shape[1:], device=p.x.device)
    for s in range(steps):
        d = n >> (s + 1)
        rolled = jselect(idx < n - d, _roll(p, -d), inf)
        p = jadd(p, rolled)
    return JPoints(p.x[..., 0], p.y[..., 0], p.z[..., 0])


def pad_pow2(p: JPoints, min_width: int = 1) -> JPoints:
    """Pad the last axis with infinity up to the next power of two."""
    n = p.x.shape[-1]
    m = max(min_width, 1)
    while m < n:
        m *= 2
    if m == n:
        return p
    pad = jinf(p.x.shape[1:-1] + (m - n,), device=p.x.device)
    return JPoints(
        torch.cat([p.x, pad.x], dim=-1),
        torch.cat([p.y, pad.y], dim=-1),
        torch.cat([p.z, pad.z], dim=-1),
    )


def tree_reduce_hybrid(p: JPoints) -> JPoints:
    """Sum all lanes of the last axis (any width; padded internally)."""
    p = pad_pow2(p)
    n = p.x.shape[-1]
    if n == 1:
        return JPoints(p.x[..., 0], p.y[..., 0], p.z[..., 0])
    while n > SMALL_WIDTH:
        n //= 2
        lo = JPoints(p.x[..., :n], p.y[..., :n], p.z[..., :n])
        hi = JPoints(p.x[..., n:], p.y[..., n:], p.z[..., n:])
        p = jadd(lo, hi)
    return _hs_reduce(p)


def inclusive_scan(p: JPoints) -> JPoints:
    """Inclusive group-prefix-scan along the last axis (width = power of 2)."""
    n = p.x.shape[-1]
    if n & (n - 1):
        raise ValueError("inclusive_scan requires power-of-two width")
    if n <= SMALL_WIDTH:
        return _hs_scan(p)
    ev, od = _split_even_odd(p)
    pairs = jadd(ev, od)  # width n/2: sums of adjacent pairs
    sp = inclusive_scan(pairs)  # prefixes at odd positions
    evens = jadd(_shift_in_inf(sp), ev)  # prefixes at even positions
    return _interleave(evens, sp)


# ---------------------------------------------------------------------------
# inclusive_scan as a level schedule over records
# ---------------------------------------------------------------------------

# The buffers of a scheduled scan, each (rows, wb, columns) int32: the
# gathered records (49 rows: x, y, the infinity word), the scratch and the
# prefix table (72 rows each: X, Y, Z).
RECORDS, SCRATCH, TABLE = 0, 1, 2

# The strided kernel's bodies (csrc/kernels.cu, `StridedBody`), one named by
# each launch: ANY reads and writes any views (the fixed-width steps); UP
# reads p and q as columns 2j and 2j + 1 of one buffer, one 8-byte pair a
# limb row (a level up); DOWN takes the copied prefix from the next lane's p
# and stores out and copy_out as one pair (a level down). The card refuses
# an UP or DOWN launch whose views do not have that layout.
ANY, UP, DOWN = 0, 1, 2


class Operand(NamedTuple):
    """Where lane j of a launch lies in each of the wb rows: column
    off + j * step of buffer `buf`. Lanes below `lo` take the identity
    (1, 1, 0) instead and read nothing. A record operand is lifted as it is
    read: z = 0 where the infinity word is set, else one in Montgomery form."""

    buf: int
    off: int
    step: int = 1
    lo: int = 0


class Launch(NamedTuple):
    """One launch over `lanes` lanes a row: out[j] = jadd(p[j], q[j]), and
    where `copy` is given also copy_out[j] = copy[j]; `kind` the kernel
    body that runs it (ANY, UP or DOWN)."""

    lanes: int
    p: Operand
    q: Operand
    out: Operand
    copy: Optional[Operand] = None
    copy_out: Optional[Operand] = None
    kind: int = ANY


@functools.lru_cache(maxsize=None)
def scan_schedule(n: int, small_width: int) -> Tuple[int, Tuple[Launch, ...]]:
    """The launches of `inclusive_scan` at width n (a power of two) over
    records, and the scratch columns they need. The adds and their operands
    are `inclusive_scan`'s, level for level; only where the values live
    differs. With n_k = n >> k and K the levels while n_k > small_width:

      up (UP), k < K:  pairs_k[j] = jadd(in_k[2j], in_k[2j+1]); in_0 = the
                  records, in_k = pairs_{k-1}, each pairs_k a compact region
                  of the scratch, kept for the way down
      fixed width (ANY): the `_hs_scan` steps over in_K,
                  p'[i] = jadd(p[i], i >= d ? p[i-d] : identity), between
                  two scratch regions, the last step into out_K
      down (DOWN), k < K, from K-1: out_k[2j] = jadd(j > 0 ? sp[j-1] : identity,
                  in_k[2j]) and out_k[2j+1] = sp[j], sp = out_{k+1}

    out_0 is the table; out_k for k > 0 takes turns between two scratch
    regions by the parity of k. No launch writes a region it reads."""
    if n < 1 or n & (n - 1):
        raise ValueError("inclusive_scan requires power-of-two width")
    K = 0
    while n >> K > small_width:
        K += 1
    nk = n >> K
    cols = 0

    def region(width):
        # even offsets: the card reads and writes levels as 8-byte pairs
        nonlocal cols
        off, cols = cols, cols + width + (width & 1)
        return off

    pairs = [region(n >> (k + 1)) for k in range(K)]
    temps = (region(nk), region(nk))
    down = {k % 2: region(n >> k) for k in (1, 2) if k <= K}  # the widest out_k of each parity

    def src(k):
        return (RECORDS, 0) if k == 0 else (SCRATCH, pairs[k - 1])

    def dst(k):
        return (TABLE, 0) if k == 0 else (SCRATCH, down[k % 2])

    launches = []
    for k in range(K):
        b, o = src(k)
        launches.append(
            Launch(n >> (k + 1), Operand(b, o, 2), Operand(b, o + 1, 2), Operand(SCRATCH, pairs[k]), kind=UP)
        )
    steps = max(1, (nk - 1).bit_length())
    b, o = src(K)
    for s in range(steps):
        d = 1 << s
        ob, oo = dst(K) if s == steps - 1 else (SCRATCH, temps[s % 2])
        launches.append(Launch(nk, Operand(b, o), Operand(b, o - d, 1, d), Operand(ob, oo)))
        b, o = ob, oo
    for k in reversed(range(K)):
        sb, so = dst(k + 1)
        eb, eo = src(k)
        ob, oo = dst(k)
        launches.append(
            Launch(
                n >> (k + 1),
                Operand(sb, so - 1, 1, 1),
                Operand(eb, eo, 2),
                Operand(ob, oo, 2),
                Operand(sb, so),
                Operand(ob, oo + 1, 2),
                DOWN,
            )
        )
    return cols, tuple(launches)


def _check_records(g: torch.Tensor) -> None:
    if g.ndim != 3 or g.shape[0] != 49:
        raise ValueError(f"expected (49, wb, n) records, got {tuple(g.shape)}")


def scan_launches(g: torch.Tensor) -> int:
    """Kernel launches `inclusive_scan_records` makes for records g: the
    schedule's on the card, none on the CPU."""
    return len(scan_schedule(g.shape[-1], SMALL_WIDTH)[1]) if g.is_cuda else 0


def inclusive_scan_records(g: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix scan of gathered point records g (49, wb, n), n a
    power of two, along the last axis -> the (72, wb, n) table [X, Y, Z] of
    `inclusive_scan(lift(g))`, bit for bit. CUDA tensors run `scan_schedule`
    on the strided point kernel (`cuda_g1.point_strided`); CPU tensors
    `lift`, `inclusive_scan` and a concatenation."""
    _check_records(g)
    if g.is_cuda:
        from curdleproofs_tpu_torch.ops import cuda_g1

        return _run_schedule(g, cuda_g1.point_strided)
    P = inclusive_scan(lift(APoints(g[:24], g[24:48], g[48] != 0)))
    return torch.cat([P.x, P.y, P.z], dim=0)


def inclusive_scan_levels_ref(g: torch.Tensor) -> torch.Tensor:
    """`scan_schedule` run with the plain formulas on any device: the same
    buffers, offsets, strides and identity lanes as the card's launches,
    each launch read whole, added and stored."""
    _check_records(g)
    return _run_schedule(g, _plain_launch)


def _run_schedule(g: torch.Tensor, launch) -> torch.Tensor:
    _, wb, n = g.shape
    cols, launches = scan_schedule(n, SMALL_WIDTH)
    bufs = (
        g,
        torch.empty((72, wb, cols), dtype=torch.int32, device=g.device),
        torch.empty((72, wb, n), dtype=torch.int32, device=g.device),
    )
    for step in launches:
        launch(bufs, step)
    return bufs[TABLE]


def _columns(op: Operand, lanes: int, device) -> torch.Tensor:
    j = torch.arange(lanes, device=device)
    return op.off + op.step * j.clamp(min=op.lo)


def _plain_read(bufs, op: Operand, lanes: int) -> JPoints:
    t = bufs[op.buf][:, :, _columns(op, lanes, bufs[op.buf].device)]
    if op.buf == RECORDS:
        p = lift(APoints(t[:24], t[24:48], t[48] != 0))
    else:
        p = JPoints(t[:24], t[24:48], t[48:])
    if op.lo:
        keep = torch.arange(lanes, device=t.device) >= op.lo
        p = jselect(keep, p, jinf(p.x.shape[1:], device=t.device))
    return p


def _plain_write(bufs, op: Operand, lanes: int, p: JPoints) -> None:
    bufs[op.buf][:, :, _columns(op, lanes, bufs[op.buf].device)] = torch.cat([p.x, p.y, p.z], dim=0)


def _plain_launch(bufs, step: Launch) -> None:
    res = _jadd_formulas(_plain_read(bufs, step.p, step.lanes), _plain_read(bufs, step.q, step.lanes))
    _plain_write(bufs, step.out, step.lanes, res)
    if step.copy is not None:
        _plain_write(bufs, step.copy_out, step.lanes, _plain_read(bufs, step.copy, step.lanes))
