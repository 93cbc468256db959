"""Multi-scalar multiplication: the GLV-split streaming Pippenger for large
n, the GLV ladder for everything below it, and the two sort-based Pippenger
engines.

Counterpart of the JAX package's `ops.msm`: `msm()` -> `msm_pippenger_stream`
-> `_msm_stream_impl` -> `_stream_chunks` (a device body per chunk of
windows; the sharded engine, parallel.msm, runs the same loop) ->
`_combine_windows_host` from STREAM_MIN lanes up, and `msm()` -> `msm_ladder` (one `ladder_glv`
launch, then a tree reduce over the point kernel) below it;
`msm_ladder_segmented` runs K independent same-width MSMs as one launch;
`msm_pippenger` (sort on the device) and `msm_pippenger_hostsort` (sort on
the host) are the engines the streaming one grew out of, reached through
`msm(method="pippenger" | "hostsort")`.

The Pippenger all of them share:

For each c-bit window w with digits d_i and buckets t in [0, 2^c):
    S_w = sum_i d_i * P_i = sum_t t * bucket_t
Sorting lanes by digit makes every bucket a contiguous segment, so with the
inclusive group prefix P and boundary indices e_t = (last sorted lane with
digit <= t):
    S_w = (B-1) * total  -  sum_{t=0}^{B-2} P[e_t]
No scatter, no data-dependent shapes, exact for any input including repeated
digits, zero scalars and infinity points. In the streaming engine the work
splits by processor:

  * HOST: GLV decomposition, digit extraction, per-window stable counting
    sort, bucket boundaries, boundary-selection schedule: one call into the
    native library (utils.host_native) where the machine has a C compiler,
    the numpy chain (`glv.decompose` -> `host_digits` -> `stream_host_prep`
    -> `_build_sel`) elsewhere, on the redo and with the GLV split off. With
    `routed=True` also the route solves (ops.route), one per window on a
    thread pool.
  * DEVICE: gathering point records into digit-sorted order (ops.gather: the
    direct gather, or the 3-stage routed gather), one mixed add per record
    in the streaming scan (ops.stream_scan), the lane-offset stitch and the
    bucket-boundary reduce (ops.scan over the point kernel).
  * HOST: the Horner combination of the window sums, O(255) exact point ops.

The fast path scans without the doubling branch and emits only the
host-selected boundary prefixes (`_stream_window_partials_sel`, or
`_stream_window_partials_routed_sel` behind the routed gather); a doubling
flag or a selection-slot overflow sends the work to the complete,
full-prefix scan (`_stream_window_partials` / `_stream_window_partials_routed`).
The result is always exact.

The JAX package packs the index tables of a chunk into one int16 buffer for
its host-to-device link (`_pack_idx_chunk`, `_decode_packed_tables`); here
they go to the card as the int32 arrays they are.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from curdleproofs_tpu_torch.curve import _JINF, G1, _jadd, _jdbl, msm_host
from curdleproofs_tpu_torch.fields import Fr
from curdleproofs_tpu_torch.ops import cuda_g1
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import gather as ogather
from curdleproofs_tpu_torch.ops import glv as oglv
from curdleproofs_tpu_torch.ops import modarith as ma
from curdleproofs_tpu_torch.ops import route as oroute
from curdleproofs_tpu_torch.ops import scan as oscan
from curdleproofs_tpu_torch.ops import stream_scan as ostream
from curdleproofs_tpu_torch.ops.cuda_g1 import _beta_mont_limbs
from curdleproofs_tpu_torch.ops.fieldspec import FQ_SPEC, from_reference, ints_to_limbs, to_reference
from curdleproofs_tpu_torch.ops.g1 import APoints, JPoints
from curdleproofs_tpu_torch.utils import host_native
from curdleproofs_tpu_torch.utils.device import DeviceArg, resolve_device
from curdleproofs_tpu_torch.utils.profiling import metrics, timed

FR_BITS = 255

# GLV endomorphism split inside the stream engine (see _msm_stream_impl):
# halves the window count for the same scan work. The JAX package's knob,
# under its name and default (CURDLEPROOFS_STREAM_GLV=0 switches it off);
# tests switch it off to exercise the non-split path.
STREAM_GLV = os.environ.get("CURDLEPROOFS_STREAM_GLV", "1") == "1"
GLV_STREAM_MIN_N = 128  # below this, decompose/packing overhead dominates

# The scan with in-step boundary selection takes over from the full-prefix
# scan at this lane count (the JAX package ties it to its routed gather,
# ROUTE_MIN_N there). Tests lower it.
SEL_MIN_N = 1 << 14

# The routed (3-stage) sorted-order gather. The JAX package takes it from
# ROUTE_MIN_N lanes up, because its direct gather costs a matrix product
# quadratic in n. Here the direct gather is one indexed copy, and the routed
# one costs three such copies, three transposes and a route solve per window
# on the host, so `routed=None` means the direct gather at every size
# (PERF.md has the two walls at n = 2^16) and the routed gather runs where
# the caller passes `routed=True`. ROUTE_MIN_FACTOR is the least r and c of
# the (r x c) view; tests lower it.
ROUTE_MIN_FACTOR = 128
# windows per chunk when routed: a chunk launches as soon as its solves land
ROUTE_WINDOW_BATCH = 2

# boundary-selection slot capacities per scan step, tried smallest first.
# DISTINCT ranks per (window, step) have mean occupancy (B-1)/T; escalating
# to 256 rescues concentrated digit distributions before the full-prefix
# fallback. S only sizes the kernel output and the compact bpos gather —
# multiplicity lives in the bpos gather.
SEL_SLOT_OPTIONS = (128, 256)

# Above this width one MSM runs as SLICES of this size plus one host add per
# extra slice (MSM is linear in its (point, scalar) pairs); each slice picks
# its own window bits. 0 disables. CURDLEPROOFS_STREAM_SPLIT, as in the JAX
# package.
STREAM_SPLIT = int(os.environ.get("CURDLEPROOFS_STREAM_SPLIT", str(1 << 16)))

# auto-dispatch: the streaming Pippenger takes sizes from here up
# (CURDLEPROOFS_STREAM_MIN, as in the JAX package)
STREAM_MIN = int(os.environ.get("CURDLEPROOFS_STREAM_MIN", str(1 << 14)))

# The JAX package's crossover between its sort-based Pippenger and its XLA
# ladder on a CPU backend; `msm()` here never dispatches on it (below
# STREAM_MIN it runs the GLV ladder kernel), kept under its name.
LADDER_THRESHOLD = 2048

# At or below this size exact host arithmetic beats a device round-trip.
HOST_THRESHOLD = 16


def _combine_windows_host(total: G1, bsums: List[G1], c: int, num_windows: int) -> G1:
    """S = sum_w 2^{cw} * ((B-1)*total - bsums[w]), Horner, exact host math
    in Jacobian coordinates (one inversion, at the end)."""
    big = (total * Fr((1 << c) - 1))._jacobian()
    acc = _JINF
    for w in reversed(range(num_windows)):
        for _ in range(c):
            acc = _jdbl(acc)
        acc = _jadd(acc, _jadd(big, (-bsums[w])._jacobian()))
    return G1._from_jacobian(acc)


def pick_window(n: int) -> int:
    """Window size balancing scan work vs bucket reduce. For the GLV-split
    stream engine W = ceil(130/c). The JAX package's choices, kept so both
    run the same schedule; not yet tuned for this card."""
    if n <= 32:
        return 4
    if n <= 1024:
        return 8
    if n <= 1 << 16:
        return 13
    return 15


def host_digits(scalars: np.ndarray, c: int, bits: int = FR_BITS) -> np.ndarray:
    """(L16, n) limbs -> (W, n) uint16 c-bit window digits with
    W = ceil(bits / c) (bits < 16 * rows(scalars) + 1)."""
    if not 1 <= c <= 16:
        raise ValueError("window size must be in [1, 16]")
    W = -(-bits // c)
    s = np.concatenate(
        [scalars.astype(np.uint32), np.zeros((2,) + scalars.shape[1:], np.uint32)]
    )
    mask = np.uint32((1 << c) - 1)
    rows = []
    for w in range(W):
        i0, off = divmod(w * c, 16)
        v = s[i0] >> np.uint32(off)
        if off + c > 16:
            v = v | (s[i0 + 1] << np.uint32(16 - off))
        rows.append(v & mask)
    return np.stack(rows).astype(np.uint16)


def extract_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(16, n) canonical Fr limbs on the device -> (W, n) int32 c-bit window
    digits (c <= 16); the tensor twin of `host_digits`."""
    if not 1 <= c <= 16:
        raise ValueError("window size must be in [1, 16]")
    W = -(-FR_BITS // c)
    pad = torch.zeros((2,) + tuple(scalars.shape[1:]), dtype=scalars.dtype, device=scalars.device)
    s = torch.cat([scalars, pad], dim=0)
    mask = (1 << c) - 1
    rows = []
    for w in range(W):
        i0, off = divmod(w * c, 16)
        v = s[i0] >> off
        if off + c > 16:
            v = v | (s[i0 + 1] << (16 - off))
        rows.append(v & mask)
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# The sort-based Pippenger engines: the formula above with the whole prefix
# P from `ops.scan.inclusive_scan` (about 2n complete adds per window over
# the point kernel). `msm_pippenger` sorts on the device (torch.sort and
# torch.searchsorted, library calls as they are XLA ops in the JAX package),
# `msm_pippenger_hostsort` on the host (numpy). Records and boundary
# prefixes are fetched with `gather_u32`; an empty prefix (index -1) gathers
# the zero triple, which is the identity.
# ---------------------------------------------------------------------------


def _sorted_window_partials(packed, order, e):
    """Device pipeline for one window chunk: packed (49, n) point records,
    order (wb, n) int32 digit-sort permutations, e (wb, B-1) int32 bucket
    boundary ranks in the sorted order (-1 = empty prefix). Returns (total
    JPoints (24,), bucket-weighted boundary sums (24, wb)). One span a
    step: `msm.window.gather`, `.scan` (its items: the scan's kernel
    launches, none on the CPU), `.reduce`."""
    with timed("msm.window.gather"):
        g = ogather.gather_u32_shared(packed, order)  # (49, wb, n)
    with timed("msm.window.scan", items=oscan.scan_launches(g)):
        P = oscan.inclusive_scan_records(g)  # (72, wb, n)
    with timed("msm.window.reduce"):
        bg = ogather.gather_u32(P, e)  # (72, wb, B-1)
        bsums = oscan.tree_reduce_hybrid(_split72(bg))  # (24, wb)
        total = _split72(P[:, 0, -1])
    return total, bsums


def _window_partials(packed, digits, c: int):
    """`_sorted_window_partials` for digits (wb, n) on the device: the sort
    and the bucket boundaries are computed there (span `msm.window.sort`)."""
    B = 1 << c
    with timed("msm.window.sort"):
        sd, order = torch.sort(digits, dim=-1, stable=True)
        ts = torch.arange(B - 1, dtype=digits.dtype, device=digits.device)
        e = torch.searchsorted(sd, ts.expand(digits.shape[0], -1).contiguous(), right=True) - 1
        order, e = order.to(torch.int32).contiguous(), e.to(torch.int32).contiguous()
    return _sorted_window_partials(packed, order, e)


def _pad_pow2_inputs(points: APoints, scalars: torch.Tensor, min_width: int = 32):
    """Pad to a power of two (>= min_width), which `inclusive_scan` needs;
    identity bases / zero scalars are no-ops."""
    n = points.x.shape[-1]
    m = _pow2_at_least(n, min_width)
    if m == n:
        return points, scalars
    spad = torch.zeros((scalars.shape[0], m - n), dtype=scalars.dtype, device=scalars.device)
    return _pad_points(points, m), torch.cat([scalars, spad], dim=-1)


def hostsort_point_ops(n: int, c: int) -> int:
    """Group adds executed per MSM by the sort-based Pippenger engines."""
    W = -(-FR_BITS // c)
    return W * (2 * n + (1 << c)) + 255


def _sorted_window_batch(n: int, W: int) -> int:
    """Windows per chunk: bounds the scan's working set (about 600 rows of
    32 bits per lane are live) to about 10 GB."""
    return max(1, min(W, (1 << 22) // max(n, 1)))


def msm_pippenger(
    points: APoints,
    scalars: torch.Tensor,
    c: Optional[int] = None,
    window_batch: Optional[int] = None,
) -> G1:
    """Full MSM with the sort on the device: points (24, n) affine tensors,
    scalars (16, n) canonical limbs as a tensor on the same device -> host
    G1."""
    n_in = points.x.shape[-1]
    c_est = c or pick_window(max(n_in, 32))
    with timed("msm.pippenger", items=n_in, point_ops=hostsort_point_ops(n_in, c_est)):
        return _msm_pippenger_impl(points, scalars, c, window_batch)


def _msm_pippenger_impl(points, scalars, c=None, window_batch=None) -> G1:
    """Spans: `msm.pippenger.prep` (the pad, the digits, the records),
    `msm.pippenger.windows` (every chunk's device work enqueued, and the
    results packed), then `_combine_packed`'s."""
    with timed("msm.pippenger.prep"):
        points, scalars = _pad_pow2_inputs(points, scalars)
        n = points.x.shape[-1]
        c = c or pick_window(n)
        W = -(-FR_BITS // c)
        if window_batch is None:
            window_batch = _sorted_window_batch(n, W)
        digits = extract_digits(scalars, c)
        packed = _pack_records(points)
    with timed("msm.pippenger.windows"):
        pending = [
            _window_partials(packed, digits[w0 : w0 + window_batch], c)
            for w0 in range(0, W, window_batch)
        ]
        res = _pack_results(pending[0][0], [b for _, b in pending])
    return _combine_packed(res, c, W)


def msm_pippenger_hostsort(
    points: APoints,
    scalars: np.ndarray,
    c: Optional[int] = None,
    window_batch: Optional[int] = None,
) -> G1:
    """Full MSM with the sort on the host: points (24, n) affine tensors,
    scalars (16, n) canonical limbs as HOST numpy -> host G1."""
    scalars_np = np.asarray(scalars).astype(np.uint32)
    n_in = points.x.shape[-1]
    c = c or pick_window(max(n_in, 32))
    with timed("msm.hostsort", items=n_in, point_ops=hostsort_point_ops(n_in, c)):
        return _msm_hostsort_impl(points, scalars_np, c, window_batch)


def _msm_hostsort_impl(points, scalars_np, c: int, window_batch=None) -> G1:
    dev = points.x.device
    n_in = points.x.shape[-1]
    n = _pow2_at_least(n_in, 32)
    if n != n_in:  # pad with identity/zero lanes to a power of two
        points = _pad_points(points, n)
        scalars_np = np.concatenate([scalars_np, np.zeros((16, n - n_in), np.uint32)], axis=-1)
    W = -(-FR_BITS // c)
    B = 1 << c
    if window_batch is None:
        window_batch = _sorted_window_batch(n, W)
    # host: digits, per-window stable argsort, bucket boundaries
    digits = host_digits(scalars_np, c)  # (W, n) uint16
    order = np.argsort(digits, axis=-1, kind="stable").astype(np.int32)
    sd = np.take_along_axis(digits, order.astype(np.intp), axis=-1)
    ts = np.arange(B - 1, dtype=np.uint16)
    e = np.empty((W, B - 1), np.int32)
    for w in range(W):
        e[w] = np.searchsorted(sd[w], ts, side="right").astype(np.int32) - 1
    packed = _pack_records(points)
    pending = []
    for w0 in range(0, W, window_batch):
        sl = slice(w0, w0 + window_batch)
        pending.append(
            _sorted_window_partials(packed, from_reference(order[sl], dev), from_reference(e[sl], dev))
        )
    return _combine_packed(_pack_results(pending[0][0], [b for _, b in pending]), c, W)


def stream_point_ops(n: int, c: int) -> int:
    """Group adds executed per MSM by the streaming host-sorted Pippenger:
    one mixed add per record + ~2 log2(L)*L lane-offset adds + 2(B-1)
    boundary/reduce adds per window, + the host window combine. With the
    GLV split the records double (2n lanes) but W halves."""
    m = 128
    while m < n:
        m *= 2
    if STREAM_GLV and m >= GLV_STREAM_MIN_N:
        W = -(-130 // c)
        n_eff = 2 * m
    else:
        W = -(-FR_BITS // c)
        n_eff = m
    L = ostream.pick_lanes(n_eff)
    return W * (n_eff + 2 * L.bit_length() * L + 2 * (1 << c)) + W * c + W


def _glv_stream_packed(px, py, pinf, neg1):
    """Lane-doubled stream records for the GLV split: [sgn(neg1)·P | phi(P)]
    with phi(x, y) = (beta·x, y) and sgn negating y where s1 was negative.
    (24, n) Montgomery affine coords -> (49, 2n) packed records. Identity
    lanes ride on the inf flag (their 0-coords map to 0 under both ops).
    The JAX package jits this into one XLA program; here a CUDA tensor goes
    to one launch of `cuda_g1.glv_records` (csrc/field_kernels.cu), a CPU
    tensor to the plain version."""
    if px.is_cuda:
        return cuda_g1.glv_records(px, py, pinf, neg1)
    return _glv_stream_packed_plain(px, py, pinf, neg1)


def _glv_stream_packed_plain(px, py, pinf, neg1):
    """The plain version of `_glv_stream_packed`, on `ops.modarith`."""
    beta = from_reference(_beta_mont_limbs(), px.device).reshape(24, 1).expand_as(px)
    y1 = ma.select(neg1, ma.neg(FQ_SPEC, py), py)
    x2 = ma.mont_mul(FQ_SPEC, px, beta)
    infu = pinf.unsqueeze(0).to(px.dtype)
    return torch.cat(
        [torch.cat([px, y1, infu], dim=0), torch.cat([x2, py, infu], dim=0)], dim=1
    )


def _split72(t: torch.Tensor) -> JPoints:
    return JPoints(t[:24], t[24:48], t[48:])


def _stitch_and_reduce(local_tab, bpos, totals, lidx, L: int):
    """The tail both device bodies share: lane-offset scan over the lane
    totals, boundary = local prefix + lane offset, one tree reduce."""
    lane_scan = oscan._hs_scan(_split72(totals))  # (24, wb, L) inclusive over lanes
    total = JPoints(
        lane_scan.x[:, 0, L - 1], lane_scan.y[:, 0, L - 1], lane_scan.z[:, 0, L - 1]
    )
    lane_tab = torch.cat([lane_scan.x, lane_scan.y, lane_scan.z], dim=0)
    bl = ogather.gather_u32(local_tab, bpos)  # (72, wb, B-1) local prefixes
    lo = ogather.gather_u32(lane_tab, lidx)  # (72, wb, B-1) lane offsets
    boundary = og.jadd(_split72(bl), _split72(lo))
    bsums = oscan.tree_reduce_hybrid(boundary)  # (24, wb)
    return total, bsums


def _stream_tail(g, bidx, lidx, T: int, L: int):
    """Gathered records (49, wb, n) -> complete full-prefix scan -> tail."""
    wb = g.shape[1]
    prefix, totals = ostream.scan_records(g.reshape(49, wb * T * L), wb, T, L)
    return _stitch_and_reduce(prefix, bidx, totals, lidx, L)


def _stream_sel_tail(g, sel, bpos, lidx, T: int, L: int, S: int):
    """Gathered records (49, wb, n) -> no-doubling scan with in-step boundary
    selection -> tail. Returns (total, bsums, flags (wb,))."""
    wb = g.shape[1]
    bsel, totals, flags = ostream.scan_records_sel(
        g.reshape(49, wb * T * L), sel, wb, T, L, S
    )
    total, bsums = _stitch_and_reduce(bsel, bpos, totals, lidx, L)
    return total, bsums, flags


def _stream_window_partials(packed, idx_cm, bidx, lidx, T: int, L: int):
    """Device pipeline for one window chunk on the complete, full-prefix scan.

    packed (49, n) int32 point records; idx_cm (wb, n) int32 column-major
    digit-sort gather order; bidx (wb, B-1) int32 within-window flat
    positions (t*L + l) of bucket-boundary prefixes, -1 for empty; lidx
    (wb, B-1) int32 within-window lane-offset positions (lane(e) - 1), -1
    when lane(e) == 0 or the boundary is empty. Out-of-range gathers return
    zeros, and an all-zero Jacobian triple has z == 0 == infinity, so no
    masking is needed anywhere. Returns (total JPoints (24,), bucket-weighted
    boundary sums (24, wb))."""
    g = ogather.gather_u32_shared(packed, idx_cm)  # (49, wb, n)
    return _stream_tail(g, bidx, lidx, T, L)


def _stream_window_partials_routed(packed, i1, i2, i3, bidx, lidx, T: int, L: int):
    """`_stream_window_partials` with the sorted-order gather replaced by the
    3-stage routed gather (ops.route + ops.gather.routed_gather): the
    column-major sort permutation arrives factored into within-row /
    within-column local index tables i1 (wb, r, c), i2 (wb, c, r),
    i3 (wb, r, c)."""
    g = ogather.routed_gather(packed, i1, i2, i3)  # (49, wb, n)
    return _stream_tail(g, bidx, lidx, T, L)


def _stream_window_partials_sel(packed, idx_cm, sel, bpos, lidx, T: int, L: int, S: int):
    """Device pipeline for one window chunk with in-scan boundary selection:
    the scan emits only the DISTINCT bucket-boundary prefixes (host-scheduled
    into (T, S) slots), never the full (72, wb, n) prefix vector. Duplicate
    boundaries (empty buckets) are resolved by `bpos`: a per-boundary gather
    from the COMPACT (T*S)-wide selected-prefix table, so a rank selected
    once can be consumed with any multiplicity. Returns (total, bsums, flags
    (wb,)); a nonzero flag invalidates the chunk."""
    g = ogather.gather_u32_shared(packed, idx_cm)  # (49, wb, n)
    return _stream_sel_tail(g, sel, bpos, lidx, T, L, S)


def _stream_window_partials_routed_sel(
    packed, i1, i2, i3, sel, bpos, lidx, T: int, L: int, S: int
):
    """`_stream_window_partials_sel` behind the routed gather: the JAX
    package's production body (`_routed_sel_body` there)."""
    g = ogather.routed_gather(packed, i1, i2, i3)  # (49, wb, n)
    return _stream_sel_tail(g, sel, bpos, lidx, T, L, S)


def _build_sel(e: np.ndarray, T: int, S: int):
    """Schedule DISTINCT boundary ranks into per-step selection slots.

    A boundary at sorted rank e is only observable at scan step e % T (its
    offset inside its lane's block), so the step is forced; what we control
    is deduplication — empty buckets repeat the previous boundary rank, and
    scheduling each distinct rank ONCE keeps the per-cell occupancy near
    (B-1)/T. Multiplicity is reinstated downstream by the `bpos` gather.

    e (W, B-1) int64 boundary ranks (-1 = empty prefix, contributes the
    identity). Returns (sel (W*T, S) int32 lane ids (-1 = empty slot),
    bpos (W, B-1) int32 per-boundary flat positions t*S + slot into the
    per-window (T*S) selected table, -1 for e < 0), or (None, None) if any
    (window, step) needs more than S slots."""
    W, Bm1 = e.shape
    sel = np.full((W * T, S), -1, np.int32)
    bpos = np.full((W, Bm1), -1, np.int32)
    for w in range(W):
        valid = e[w] >= 0
        ranks = e[w][valid].astype(np.int64)
        if ranks.size == 0:
            continue
        uniq, inv = np.unique(ranks, return_inverse=True)
        ut = uniq % T
        ul = (uniq // T).astype(np.int32)
        o = np.argsort(ut, kind="stable")
        ts = ut[o]
        starts = np.searchsorted(ts, np.arange(T))
        slot_sorted = np.arange(ts.size) - starts[ts]
        if slot_sorted.size and slot_sorted.max() >= S:
            return None, None
        slot = np.empty(ts.size, np.int64)
        slot[o] = slot_sorted
        sel[w * T + ut, slot] = ul
        bpos[w, valid] = (ut * S + slot).astype(np.int32)[inv.reshape(-1)]
    return sel, bpos


def stream_host_prep(digits: np.ndarray, c: int, L: int):
    """Host index prep for the streaming scan: digit-sort permutations in
    column-major device layout + bucket-boundary/lane-offset index tables.

    digits (W, n) uint16 -> (order_cm (W, n) i32, bidx (W, B-1) i32,
    lidx (W, B-1) i32, e (W, B-1) i64 raw boundary ranks)."""
    W, n = digits.shape
    T = n // L
    B = 1 << c
    order = np.argsort(digits, axis=-1, kind="stable").astype(np.int32)
    sd = np.take_along_axis(digits, order.astype(np.intp), axis=-1)
    ts = np.arange(B - 1, dtype=np.uint16)
    e = np.empty((W, B - 1), np.int64)
    for w in range(W):
        e[w] = np.searchsorted(sd[w], ts, side="right") - 1
    # column-major relabel: device flat position t*L + l holds sorted rank
    # l*T + t, so lane l's thread walks ranks [l*T, (l+1)*T)
    order_cm = np.ascontiguousarray(order.reshape(W, L, T).transpose(0, 2, 1)).reshape(W, n)
    t_e, l_e = e % T, e // T
    bidx = np.where(e >= 0, t_e * L + l_e, -1).astype(np.int32)
    lidx = np.where((e >= 0) & (l_e > 0), l_e - 1, -1).astype(np.int32)
    return order_cm, bidx, lidx, e


def stream_prep(
    scalars_np: np.ndarray, c: int, L: int, glv_split: bool, want_sel: bool,
    native: bool = True, span: str = "msm.stream.host_prep", on_order=None,
):
    """The streaming engine's host prep, shared by `msm()` and the sharded
    engine (parallel.msm), so both choose it alike. scalars_np (16, n) limbs;
    with glv_split the GLV split (the lanes double to 2n), then the digits,
    the stable counting sort, the boundary tables and, with want_sel, the
    boundary-selection schedule at the smallest of SEL_SLOT_OPTIONS that
    fits. The GLV prep is one call into the native library where it is
    built (and `native`), the numpy chain otherwise; the span `span.native`
    or `span.numpy` says which ran. on_order(order_cm) is called as soon as
    the sorted order exists (the route solves overlap the rest).

    Returns (neg1 (n,) bool or None, order_cm (W, lanes) i32, bidx, lidx
    (W, B-1) i32, sel_all (W*T, S) i32, bpos_all (W, B-1) i32, S), with
    sel_all and bpos_all None and S 0 when no schedule was asked for or none
    fits."""
    if glv_split and native and host_native.available():
        # ONE native call: GLV split + digits + counting sort + boundary
        # ranks + column-major relabel + boundary-selection schedule
        with timed(span + ".native"):
            out = host_native.msm_prep_batch(scalars_np, c, L, SEL_SLOT_OPTIONS if want_sel else ())
        if on_order is not None:
            on_order(out[1])
        return out
    with timed(span + ".numpy"):
        neg1 = None
        if glv_split:
            s1, neg1, s2 = oglv.decompose(scalars_np.astype(np.uint64))
            digits = host_digits(
                np.concatenate([s1, s2], axis=1).astype(np.uint32), c, bits=130
            )  # (ceil(130/c), 2n) — |s1| < 2^129 plus one bit of headroom
        else:
            digits = host_digits(scalars_np, c)  # (W, n) uint16
        order_cm, bidx, lidx, e = stream_host_prep(digits, c, L)
        if on_order is not None:  # before the selection schedule, which the solves overlap
            on_order(order_cm)
        if want_sel:
            T = order_cm.shape[1] // L
            for S in SEL_SLOT_OPTIONS:
                sel_all, bpos_all = _build_sel(e, T, S)
                if sel_all is not None:
                    return neg1, order_cm, bidx, lidx, sel_all, bpos_all, S
        return neg1, order_cm, bidx, lidx, None, None, 0


def _pow2_at_least(n: int, floor: int) -> int:
    m = floor
    while m < n:
        m *= 2
    return m


def _pad_points(points: APoints, m: int) -> APoints:
    """Pad (24, n) affine points with identity lanes up to width m."""
    n = points.x.shape[-1]
    if m == n:
        return points
    dev = points.x.device
    zc = torch.zeros((points.x.shape[0], m - n), dtype=points.x.dtype, device=dev)
    return APoints(
        torch.cat([points.x, zc], dim=-1),
        torch.cat([points.y, zc], dim=-1),
        torch.cat([points.inf, torch.ones(m - n, dtype=torch.bool, device=dev)], dim=-1),
    )


def _pack_records(points: APoints) -> torch.Tensor:
    """(24, n) affine points -> (49, n) records [x | y | inf]."""
    return torch.cat(
        [points.x, points.y, points.inf.unsqueeze(0).to(points.x.dtype)], dim=0
    ).contiguous()


def _pack_results(total: JPoints, bsums: Sequence[JPoints]) -> torch.Tensor:
    """The scan total (24,) and every chunk's boundary sums (24, wb) as ONE
    (72, 1 + W) tensor: one transfer home."""
    return torch.cat(
        [torch.cat([total.x, total.y, total.z]).reshape(72, 1)]
        + [torch.cat([b.x, b.y, b.z], dim=0).reshape(72, -1) for b in bsums],
        dim=1,
    )


def _combine_packed(res: torch.Tensor, c: int, W: int) -> G1:
    """Read a `_pack_results` tensor back and combine the windows on the host.
    Spans: `msm.readback` (the host waits for the card's queue to drain, then
    the copy home) and `msm.combine` (the points to host G1, the windows'
    Horner combine)."""
    with timed("msm.readback"):
        arr = to_reference(res)
    with timed("msm.combine"):
        pts = og.jpoints_to_host(JPoints(arr[:24], arr[24:48], arr[48:]))
        return _combine_windows_host(pts[0], pts[1 : 1 + W], c, W)


_ROUTE_POOL: Optional[ThreadPoolExecutor] = None


def _route_pool() -> ThreadPoolExecutor:
    """The route-solve thread pool, one per process with a worker per core
    (at most 8), shared by every MSM."""
    global _ROUTE_POOL
    if _ROUTE_POOL is None:
        _ROUTE_POOL = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1), thread_name_prefix="route-solve"
        )
    return _ROUTE_POOL


def _solve_route(rr: int, rc: int, row: np.ndarray):
    """One window's route solve, on a pool thread; its seconds go to the span
    `msm.stream.route_solve` (summed over the threads)."""
    t0 = time.perf_counter()
    out = oroute.decompose(rr, rc, row)
    metrics().record("msm.stream.route_solve", time.perf_counter() - t0)
    return out


def msm_pippenger_stream(
    points: APoints,
    scalars: np.ndarray,
    c: Optional[int] = None,
    window_batch: Optional[int] = None,
    sel_scan: Optional[bool] = None,
    routed: Optional[bool] = None,
) -> G1:
    """Full MSM via the streaming host-sorted Pippenger. points (24, n)
    affine tensors (the device they lie on is the device it runs on),
    scalars (16, n) canonical limbs as HOST numpy (the sort runs on host)
    -> host G1. Widths above STREAM_SPLIT run as independent slices at the
    slice size (each slice picks its own window bits), one after the other
    (two in flight were no faster on an H100 host, PERF.md), combined by
    plain addition. sel_scan forces the scan with in-step boundary selection
    on or off (default: on from SEL_MIN_N lanes). routed=True puts the
    records into sorted order with the 3-stage routed gather (route solves on
    the host, three `rowwise_gather` launches a chunk); routed=None and False
    take the direct gather, which is the faster of the two on this hardware
    (PERF.md)."""
    scalars_np = np.asarray(scalars).astype(np.uint32)
    n_in = points.x.shape[-1]
    if STREAM_SPLIT and n_in > STREAM_SPLIT:
        sz = STREAM_SPLIT
        cs = pick_window(sz)
        with timed(
            "msm.stream",
            items=n_in,
            point_ops=-(-n_in // sz) * stream_point_ops(sz, cs),
        ):
            acc = G1.identity()
            for o in range(0, n_in, sz):
                sub = APoints(
                    points.x[:, o : o + sz], points.y[:, o : o + sz], points.inf[o : o + sz]
                )
                acc = acc + _msm_stream_impl(
                    sub, scalars_np[:, o : o + sz], cs, window_batch, sel_scan, routed
                )
            return acc
    c = c or pick_window(max(n_in, 32))
    with timed("msm.stream", items=n_in, point_ops=stream_point_ops(n_in, c)):
        return _msm_stream_impl(points, scalars_np, c, window_batch, sel_scan, routed)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _stream_chunks(
    packed, order_cm, bidx, lidx, sel_all, bpos_all, S: int, T: int, L: int,
    window_batch: int, route_futs=None,
):
    """The device loop of the streaming engine, shared by `msm()` and the
    sharded engine (parallel.msm): one body a chunk of `window_batch`
    windows, on the card the packed records (49, n) lie on. The host tables
    are numpy: order_cm (W, n), bidx and lidx (W, B-1), and, for the scan
    with in-step boundary selection, sel_all (W*T, S) and bpos_all (W, B-1)
    (None: the complete, full-prefix scan). route_futs, one future a window
    of `_solve_route`, puts the records into sorted order with the routed
    gather; None takes the direct gather. Returns [(total (24,), bsums
    (24, wb), flags (wb,) or None)] a chunk, the launches still queued. The
    chunk's index tables go to the card inside one span `msm.stream.upload`."""
    dev = packed.device
    W = order_cm.shape[0]
    pending = []
    for w0 in range(0, W, window_batch):
        sl = slice(w0, w0 + window_batch)
        if route_futs is not None:
            with timed("msm.stream.route_wait"):
                parts = [f.result() for f in route_futs[sl]]
        with timed("msm.stream.upload"):
            lidx_d = from_reference(lidx[sl], dev)
            if route_futs is not None:
                gather_args = tuple(
                    from_reference(np.concatenate([p[k] for p in parts]), dev) for k in range(3)
                )
                sel_body, full_body = _stream_window_partials_routed_sel, _stream_window_partials_routed
            else:
                gather_args = (from_reference(order_cm[sl], dev),)
                sel_body, full_body = _stream_window_partials_sel, _stream_window_partials
            if sel_all is not None:
                tables = (
                    from_reference(sel_all[w0 * T : (w0 + window_batch) * T], dev),
                    from_reference(bpos_all[sl], dev),
                )
            else:
                tables = (from_reference(bidx[sl], dev),)
        if sel_all is not None:
            total, bsums, flags = sel_body(packed, *gather_args, *tables, lidx_d, T, L, S)
        else:
            total, bsums = full_body(packed, *gather_args, *tables, lidx_d, T, L)
            flags = None
        pending.append((total, bsums, flags))
    return pending


def _msm_stream_impl(
    points: APoints,
    scalars_np: np.ndarray,
    c: int,
    window_batch: Optional[int] = None,
    sel_scan: Optional[bool] = None,
    routed: Optional[bool] = None,
    _safe: bool = False,
) -> G1:
    dev = points.x.device
    points_in, scalars_in = points, scalars_np  # for the doubling fallback

    # ---- host prep --------------------------------------------------------
    with timed("msm.stream.host_prep"):
        n_in = points.x.shape[-1]
        n = _pow2_at_least(n_in, 128)
        if n != n_in:  # pad with identity/zero lanes to a power of two
            points = _pad_points(points, n)
            scalars_np = np.concatenate(
                [scalars_np, np.zeros((16, n - n_in), np.uint32)], axis=-1
            )
        # GLV endomorphism split: each 255-bit scalar becomes two <=129-bit
        # halves k = (-1)^neg*s1 + s2*lam, the lane set doubles to
        # [+-P | phi(P)], and W halves. Scan work is unchanged (W*n records
        # either way) but every per-window cost halves with W.
        glv_split = STREAM_GLV and n >= GLV_STREAM_MIN_N
        if glv_split:
            n *= 2
        if sel_scan is None:
            sel_scan = n >= SEL_MIN_N
        routed = bool(routed)  # None: the direct gather, at every size
        L = ostream.pick_lanes(n)
        T = n // L

        def submit_solves(order_cm: np.ndarray):
            # one future per window, so solves overlap each other, the rest
            # of the prep and the device work of earlier chunks
            rr, rc = oroute.pick_rc(n, ROUTE_MIN_FACTOR)
            pool = _route_pool()
            return [pool.submit(_solve_route, rr, rc, order_cm[w]) for w in range(len(order_cm))]

        # In-scan boundary selection: S adapts to the smallest slot option
        # that fits, and the full-prefix path takes over when even the
        # largest overflows. _safe forces the full-prefix path with the
        # doubling-complete scan, on the numpy prep: the redo after a
        # flagged collision.
        routes = []
        neg1, order_cm, bidx, lidx, sel_all, bpos_all, S = stream_prep(
            scalars_np, c, L, glv_split, sel_scan and not _safe, native=not _safe,
            on_order=(lambda o: routes.append(submit_solves(o))) if routed else None,
        )
        route_futs = routes[0] if routes else None
        W = order_cm.shape[0]
        if window_batch is None:
            # routed: small chunks, so a chunk launches as soon as its solves
            # land; direct: bounded by the per-chunk live set (gathered
            # records + prefix table)
            window_batch = ROUTE_WINDOW_BATCH if routed else max(1, min(W, (1 << 22) // max(n, 1)))

    # ---- device -----------------------------------------------------------
    with timed("msm.stream.device"):
        if glv_split:
            with timed("msm.stream.upload"):
                neg1_d = from_reference(neg1, dev)
            packed = _glv_stream_packed(points.x, points.y, points.inf, neg1_d).contiguous()
        else:
            packed = _pack_records(points)
        pending = _stream_chunks(
            packed, order_cm, bidx, lidx, sel_all, bpos_all, S, T, L, window_batch, route_futs
        )
        # everything rides home in ONE (72, 1+W) tensor, plus the flags
        res = _pack_results(pending[0][0], [b for _, b, _ in pending])
        flags_d = (
            torch.cat([f for _, _, f in pending]) if pending[0][2] is not None else None
        )
        _sync(dev)

    # ---- readback + combine ----------------------------------------------
    with timed("msm.stream.combine"):
        redo = flags_d is not None and bool(to_reference(flags_d).any())
        if not redo:
            out = _combine_packed(res, c, W)
    if redo:
        # a p == q doubling collision hit the fast-path scan (requires a
        # running prefix to equal the incoming base — essentially only
        # constructible on purpose). Redo on the doubling-safe full-prefix
        # pipeline: exactness preserved, cost ~2x once.
        with timed("msm.stream.redo"):
            return _msm_stream_impl(points_in, scalars_in, c, None, sel_scan, routed, _safe=True)
    return out


def ladder_point_ops(n: int, w: Optional[int] = None) -> int:
    """Group operations executed per lane by the GLV dual-table ladder MSM
    (doublings + window adds + table builds + endomorphism maps), plus the
    tree reduce."""
    if (cuda_g1.GLV_W if w is None else w) == 4:
        return (132 + 66 + 14 + 15) * n + n
    return (129 + 86 + 6 + 7) * n + n


def _ladder_msm(points: APoints, scalars_np: np.ndarray, K: int, span: str, w: Optional[int]) -> List[G1]:
    """The body the two ladder MSMs share: GLV split on the host (numpy), one
    upload of both half-scalars and the sign row, one ladder launch over all
    lanes, a tree reduce of each of the K segments, one readback."""
    n = points.x.shape[-1]
    with timed(span, items=n, point_ops=ladder_point_ops(n, w)):
        with timed(f"{span}.decompose"):
            s1, neg1, s2 = oglv.decompose(np.asarray(scalars_np).astype(np.uint64))
            halves = np.concatenate([s1, s2, neg1[None].astype(np.uint32)], axis=0)  # (19, n)
        with timed(f"{span}.device"):
            up = from_reference(halves, points.x.device)
            acc = og.scalar_mul_glv(points, up[:9], up[18], up[9:18], w=w)
            res = oscan.tree_reduce_hybrid(JPoints(*(a.reshape(24, K, n // K) for a in acc)))
            packed = torch.cat([res.x, res.y, res.z], dim=0)  # (72, K): one transfer home
            _sync(points.x.device)
        with timed(f"{span}.readback"):
            arr = to_reference(packed)
            return og.jpoints_to_host(JPoints(arr[:24], arr[24:48], arr[48:]))


def msm_ladder(points: APoints, scalars: np.ndarray, w: Optional[int] = None) -> G1:
    """Ladder MSM: GLV-split scalars (ops.glv, host numpy), one fused ladder
    over all lanes, one tree reduce. points (24, n) affine tensors (the
    device they lie on is the device it runs on), scalars (16, n) canonical
    limbs as host numpy -> host G1. No sort and no gather: about 229 group
    operations per lane against the streaming Pippenger's ~25, in exchange
    for no host prep beyond the split. w is the window width (default
    `cuda_g1.GLV_W`)."""
    return _ladder_msm(points, scalars, 1, "msm.ladder", w)[0]


def msm_naive(points: APoints, scalars: np.ndarray) -> G1:
    """The JAX package's alias of `msm_ladder` (the cross-check path)."""
    return msm_ladder(points, scalars)


def msm_ladder_segmented(
    points: APoints, scalars_np: np.ndarray, K: int, w: Optional[int] = None
) -> List[G1]:
    """K independent same-width MSMs as ONE ladder launch.

    points (24, K*m) affine, scalars (16, K*m) host numpy canonical limbs;
    segment k owns lanes [k*m, (k+1)*m). Returns the K segment results. This
    is the engine behind lockstep batch proving: 64 concurrent provers make
    every protocol MSM a 64 x 128-lane batch."""
    if points.x.shape[-1] % K:
        raise ValueError("segmented msm: width not divisible by K")
    return _ladder_msm(points, scalars_np, K, "msm.ladder_seg", w)


def msm(
    bases: Sequence[G1],
    scalars: Sequence[Fr],
    c: Optional[int] = None,
    method: str = "auto",
    device: DeviceArg = None,
    packed: Optional[APoints] = None,
) -> G1:
    """Host-facing MSM over host points/scalars. Runs on the GPU unless the
    caller passes device="cpu" (the plain PyTorch versions); with no CUDA
    device and no explicit "cpu" it raises. `packed` is `bases` already
    packed on that device (`vectors.PointVec` keeps them), skipping the
    pack.

    method "auto": exact host arithmetic up to HOST_THRESHOLD points, the GLV
    ladder below STREAM_MIN, the streaming Pippenger (direct gather) from
    there; "ladder", "stream", "hostsort" (sort-based Pippenger, sort on the
    host) and "pippenger" (sort on the device) force one engine at any
    size."""
    dev = resolve_device(device)
    if len(bases) != len(scalars):
        raise ValueError("msm length mismatch")
    if not bases:
        return G1.identity()
    n = len(bases)
    if method == "auto":
        if n <= HOST_THRESHOLD:
            # host double-and-add: ~1.5 * 255 point ops per element
            with timed("msm.host", items=n, point_ops=383 * n):
                return msm_host(list(bases), list(scalars))
        method = "stream" if n >= STREAM_MIN else "ladder"
    if method not in ("stream", "ladder", "hostsort", "pippenger"):
        raise ValueError(f"msm: unknown method {method!r}")
    with timed(f"msm.{method}.pack"):
        pts = og.pack_points(list(bases), dev) if packed is None else packed
        scs_np = np.asarray(ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32)
    if method == "ladder":
        # no pad to a multiple of 128 as in the JAX package (a compiled-shape
        # and tile rule there): the kernel masks its ragged last block
        return msm_ladder(pts, scs_np)
    if method == "stream":
        return msm_pippenger_stream(pts, scs_np, c=c)
    if method == "hostsort":
        return msm_pippenger_hostsort(pts, scs_np, c=c)
    return msm_pippenger(pts, from_reference(scs_np, dev), c=c)
