"""Multi-scalar multiplication: the GLV-split streaming Pippenger.

Counterpart of the JAX package's `ops.msm` as far as its large-n path goes:
`msm()` -> `msm_pippenger_stream` -> `_msm_stream_impl` -> a per-chunk device
body -> `_combine_windows_host`.

For each c-bit window w with digits d_i and buckets t in [0, 2^c):
    S_w = sum_i d_i * P_i = sum_t t * bucket_t
Sorting lanes by digit makes every bucket a contiguous segment, so with the
inclusive group prefix P and boundary indices e_t = (last sorted lane with
digit <= t):
    S_w = (B-1) * total  -  sum_{t=0}^{B-2} P[e_t]
No scatter, no data-dependent shapes, exact for any input including repeated
digits, zero scalars and infinity points. The work splits by processor:

  * HOST (numpy): GLV decomposition, digit extraction, per-window stable
    argsort, bucket-boundary searchsorted, boundary-selection schedule.
  * DEVICE: gathering point records into digit-sorted order (ops.gather),
    one mixed add per record in the streaming scan (ops.stream_scan), the
    lane-offset stitch and the bucket-boundary reduce (ops.scan over the
    point kernel).
  * HOST: the Horner combination of the window sums, O(255) exact point ops.

The fast path scans without the doubling branch and emits only the
host-selected boundary prefixes (`_stream_window_partials_sel`); a doubling
flag or a selection-slot overflow sends the work to the complete,
full-prefix scan (`_stream_window_partials`). The result is always exact.

This package gathers the sorted order with the direct gather kernel; the JAX
package's 3-stage routed gather (ops.route) and its native host prep belong
to a later slice of the port, as do `method="ladder"` and sizes between the
host threshold and STREAM_MIN.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from curdleproofs_tpu_torch.curve import G1, msm_host
from curdleproofs_tpu_torch.fields import Fr
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import gather as ogather
from curdleproofs_tpu_torch.ops import glv as oglv
from curdleproofs_tpu_torch.ops import modarith as ma
from curdleproofs_tpu_torch.ops import scan as oscan
from curdleproofs_tpu_torch.ops import stream_scan as ostream
from curdleproofs_tpu_torch.ops.cuda_g1 import _beta_mont_limbs
from curdleproofs_tpu_torch.ops.fieldspec import FQ_SPEC, from_reference, ints_to_limbs, to_reference
from curdleproofs_tpu_torch.ops.g1 import APoints, JPoints
from curdleproofs_tpu_torch.utils.device import DeviceArg, resolve_device
from curdleproofs_tpu_torch.utils.profiling import timed

FR_BITS = 255

# GLV endomorphism split inside the stream engine (see _msm_stream_impl):
# halves the window count for the same scan work. Tests switch it off to
# exercise the non-split path.
STREAM_GLV = True
GLV_STREAM_MIN_N = 128  # below this, decompose/packing overhead dominates

# The scan with in-step boundary selection takes over from the full-prefix
# scan at this lane count (the JAX package ties it to its routed gather,
# ROUTE_MIN_N there). Tests lower it.
SEL_MIN_N = 1 << 14

# boundary-selection slot capacities per scan step, tried smallest first.
# DISTINCT ranks per (window, step) have mean occupancy (B-1)/T; escalating
# to 256 rescues concentrated digit distributions before the full-prefix
# fallback. S only sizes the kernel output and the compact bpos gather —
# multiplicity lives in the bpos gather.
SEL_SLOT_OPTIONS = (128, 256)

# Above this width one MSM runs as SLICES of this size plus one host add per
# extra slice (MSM is linear in its (point, scalar) pairs); each slice picks
# its own window bits. 0 disables.
STREAM_SPLIT = 1 << 16

# auto-dispatch: the streaming Pippenger takes sizes from here up
STREAM_MIN = 1 << 14

# At or below this size exact host arithmetic beats a device round-trip.
HOST_THRESHOLD = 16


def _combine_windows_host(total: G1, bsums: List[G1], c: int, num_windows: int) -> G1:
    """S = sum_w 2^{cw} * ((B-1)*total - bsums[w]), Horner, exact host math."""
    B = 1 << c
    big = total * Fr(B - 1)
    wins = [big - s for s in bsums]
    acc = G1.identity()
    for w in reversed(range(num_windows)):
        for _ in range(c):
            acc = acc + acc
        acc = acc + wins[w]
    return acc


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
    Plain tensor code on whatever device the points lie on."""
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
    wb = g.shape[1]
    prefix, totals = ostream.scan_records(g.reshape(49, wb * T * L), wb, T, L)
    return _stitch_and_reduce(prefix, bidx, totals, lidx, L)


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


def _stream_window_partials_sel(packed, idx_cm, sel, bpos, lidx, T: int, L: int, S: int):
    """Device pipeline for one window chunk with in-scan boundary selection:
    the scan emits only the DISTINCT bucket-boundary prefixes (host-scheduled
    into (T, S) slots), never the full (72, wb, n) prefix vector. Duplicate
    boundaries (empty buckets) are resolved by `bpos`: a per-boundary gather
    from the COMPACT (T*S)-wide selected-prefix table, so a rank selected
    once can be consumed with any multiplicity. Returns (total, bsums, flags
    (wb,)); a nonzero flag invalidates the chunk."""
    wb = idx_cm.shape[0]
    g = ogather.gather_u32_shared(packed, idx_cm)  # (49, wb, n)
    bsel, totals, flags = ostream.scan_records_sel(
        g.reshape(49, wb * T * L), sel, wb, T, L, S
    )
    total, bsums = _stitch_and_reduce(bsel, bpos, totals, lidx, L)
    return total, bsums, flags


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


def msm_pippenger_stream(
    points: APoints,
    scalars: np.ndarray,
    c: Optional[int] = None,
    window_batch: Optional[int] = None,
    sel_scan: Optional[bool] = None,
) -> G1:
    """Full MSM via the streaming host-sorted Pippenger. points (24, n)
    affine tensors (the device they lie on is the device it runs on),
    scalars (16, n) canonical limbs as HOST numpy (the sort runs on host)
    -> host G1. Widths above STREAM_SPLIT run as independent slices at the
    slice size (each slice picks its own window bits), one after the other,
    combined by plain addition. sel_scan forces the scan with in-step
    boundary selection on or off (default: on from SEL_MIN_N lanes)."""
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
                    sub, scalars_np[:, o : o + sz], cs, window_batch, sel_scan
                )
            return acc
    c = c or pick_window(max(n_in, 32))
    with timed("msm.stream", items=n_in, point_ops=stream_point_ops(n_in, c)):
        return _msm_stream_impl(points, scalars_np, c, window_batch, sel_scan)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _msm_stream_impl(
    points: APoints,
    scalars_np: np.ndarray,
    c: int,
    window_batch: Optional[int] = None,
    sel_scan: Optional[bool] = None,
    _safe: bool = False,
) -> G1:
    dev = points.x.device
    points_in, scalars_in = points, scalars_np  # for the doubling fallback

    # ---- host prep --------------------------------------------------------
    with timed("msm.stream.host_prep"):
        n_in = points.x.shape[-1]
        m = 128
        while m < n_in:
            m *= 2
        if m != n_in:  # pad with identity/zero lanes to a power of two
            zc = torch.zeros((24, m - n_in), dtype=points.x.dtype, device=dev)
            points = APoints(
                torch.cat([points.x, zc], dim=-1),
                torch.cat([points.y, zc], dim=-1),
                torch.cat(
                    [points.inf, torch.ones(m - n_in, dtype=torch.bool, device=dev)], dim=-1
                ),
            )
            scalars_np = np.concatenate(
                [scalars_np, np.zeros((16, m - n_in), np.uint32)], axis=-1
            )
        n = m
        B = 1 << c
        # GLV endomorphism split: each 255-bit scalar becomes two <=129-bit
        # halves k = (-1)^neg*s1 + s2*lam, the lane set doubles to
        # [+-P | phi(P)], and W halves. Scan work is unchanged (W*n records
        # either way) but every per-window cost halves with W.
        glv_split = STREAM_GLV and n >= GLV_STREAM_MIN_N
        neg1 = None
        if glv_split:
            s1, neg1, s2 = oglv.decompose(scalars_np.astype(np.uint64))
            digits = host_digits(
                np.concatenate([s1, s2], axis=1).astype(np.uint32), c, bits=130
            )  # (ceil(130/c), 2n) — |s1| < 2^129 plus one bit of headroom
            n *= 2
        else:
            digits = host_digits(scalars_np, c)  # (W, n) uint16
        if sel_scan is None:
            sel_scan = n >= SEL_MIN_N
        W = digits.shape[0]
        L = ostream.pick_lanes(n)
        T = n // L
        order_cm, bidx, lidx, e = stream_host_prep(digits, c, L)
        # in-scan boundary selection: S adapts to the smallest slot option
        # that fits, and the full-prefix path takes over when even the
        # largest overflows. _safe forces the full-prefix path with the
        # doubling-complete scan — the redo after a flagged collision.
        sel_all = bpos_all = None
        S = 0
        if sel_scan and not _safe:
            for S in SEL_SLOT_OPTIONS:
                sel_all, bpos_all = _build_sel(e, T, S)
                if sel_all is not None:
                    break
        if window_batch is None:
            # per-chunk live set: gathered records + prefix table
            window_batch = max(1, min(W, (1 << 22) // max(n, 1)))

    # ---- device -----------------------------------------------------------
    with timed("msm.stream.device"):
        if glv_split:
            packed = _glv_stream_packed(
                points.x, points.y, points.inf, from_reference(neg1, dev)
            )
        else:
            packed = torch.cat(
                [points.x, points.y, points.inf.unsqueeze(0).to(points.x.dtype)], dim=0
            )
        packed = packed.contiguous()
        pending = []  # (total, bsums, flags) device handles, launches stay queued
        for w0 in range(0, W, window_batch):
            sl = slice(w0, w0 + window_batch)
            idx_d = from_reference(order_cm[sl], dev)
            lidx_d = from_reference(lidx[sl], dev)
            if sel_all is not None:
                total, bsums, flags = _stream_window_partials_sel(
                    packed,
                    idx_d,
                    from_reference(sel_all[w0 * T : (w0 + window_batch) * T], dev),
                    from_reference(bpos_all[sl], dev),
                    lidx_d,
                    T,
                    L,
                    S,
                )
            else:
                total, bsums = _stream_window_partials(
                    packed, idx_d, from_reference(bidx[sl], dev), lidx_d, T, L
                )
                flags = None
            pending.append((total, bsums, flags))
        # everything rides home in ONE (72, 1+W) tensor, plus the flags
        res = torch.cat(
            [torch.cat([pending[0][0].x, pending[0][0].y, pending[0][0].z]).reshape(72, 1)]
            + [torch.cat([b.x, b.y, b.z], dim=0).reshape(72, -1) for _, b, _ in pending],
            dim=1,
        )
        flags_d = (
            torch.cat([f for _, _, f in pending]) if pending[0][2] is not None else None
        )
        _sync(dev)

    # ---- readback + combine ----------------------------------------------
    with timed("msm.stream.combine"):
        redo = flags_d is not None and bool(to_reference(flags_d).any())
        if not redo:
            arr = to_reference(res)
            pts = og.jpoints_to_host(JPoints(arr[:24], arr[24:48], arr[48:]))
            out = _combine_windows_host(pts[0], pts[1 : 1 + W], c, W)
    if redo:
        # a p == q doubling collision hit the fast-path scan (requires a
        # running prefix to equal the incoming base — essentially only
        # constructible on purpose). Redo on the doubling-safe full-prefix
        # pipeline: exactness preserved, cost ~2x once.
        return _msm_stream_impl(points_in, scalars_in, c, None, sel_scan, _safe=True)
    return out


def msm(
    bases: Sequence[G1],
    scalars: Sequence[Fr],
    c: Optional[int] = None,
    method: str = "auto",
    device: DeviceArg = None,
) -> G1:
    """Host-facing MSM over host points/scalars. Runs on the GPU unless the
    caller passes device="cpu" (the plain PyTorch versions); with no CUDA
    device and no explicit "cpu" it raises."""
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
        if n < STREAM_MIN:
            raise NotImplementedError(
                f"msm: sizes between {HOST_THRESHOLD + 1} and {STREAM_MIN - 1} belong to the "
                "GLV ladder, which this package does not have yet (the ladder slice of the "
                "port); pass method='stream' to run the streaming Pippenger at this size"
            )
        method = "stream"
    if method != "stream":
        raise NotImplementedError(
            f"msm: method {method!r} is not in this package yet (the ladder and vector-ops "
            "slices of the port); only 'auto' and 'stream' are"
        )
    pts = og.pack_points(list(bases), dev)
    scs_np = np.asarray(ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32)
    return msm_pippenger_stream(pts, scs_np, c=c)
