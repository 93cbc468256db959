#!/usr/bin/env python3
"""GPU smoke run of curdleproofs_tpu_torch: build the CUDA kernels from the
sources in this checkout, hold each against its plain PyTorch version, and
drive the package end to end through its entry points: `msm()` on the
streaming Pippenger and on the GLV ladder, the segmented ladder MSM and the
vector ops.

    python3 chip_smoke.py            # needs one CUDA device; exits 0 on success

Phases, each printing one JSON line; any failure exits non-zero:

  device     card name and power limit (nvidia-smi), kernel build time
  kernels    the eight kernels vs their plain versions at small shapes with
             edge lanes (identity, P+P, P+(-P), a forced p == q collision in
             scan_sel, empty and repeated selection slots, out-of-range
             gather indices; for the four ladders 256 lanes with the edge
             scalars 0, 1, r-1, lambda, lambda+-1, 2^128, 14*lambda, ..., an
             identity base, two equal bases, negative k1, all three
             coordinates and the host's P*s) — integer equality
  msm_2e16   msm() at n = 2^16: bases P_i = (a + i*d + i^2*e)*G, uniform scalars;
             result == (sum s_i*dlog(P_i) mod r)*G, and first-128-scalars-only
             == msm_host; wall times and the host-prep / device / combine split
  msm_redo   all-equal bases and scalars force the doubling flag; the result
             equals the oracle and the complete scan launched
  msm_split  n = 3*2^15 + 5: two STREAM_SPLIT slices, the second padded
  msm_ladder msm() at n = 2^14 - 1 through method="auto" (the widest MSM of
             the ladder branch): == the discrete-log oracle, first 128 ==
             msm_host, wall times and the decompose / pack / device /
             readback split; once with 4-bit windows; the streaming
             Pippenger at the same n beside it; msm() at n = 17, 124, 4096
  ladder_segmented  64 segments of 128 lanes as one launch, all 64 results
             against the oracle
  vector_ops scale_points, scale_points_common, fold_points,
             fold_points_multi, add_points at n = 124 (every element against
             the host) and n = 8192 (a 256-element sample against the host,
             the sum of the whole output against the discrete-log identity);
             the bitwise ladder cross-checks the windowed one at n = 8192
  kernel_times  each kernel at the shapes the phases above give it vs its
             plain version (equality), timed with CUDA events, beside the
             least time the card could take. Launch counts are those of the
             six main-path phases above: set to 0 just before each, read just
             after it

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit. `--rehearse-cpu` walks the same control flow at
a tiny size on the CPU with the plain versions, to find faults without a
card; it prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from curdleproofs_tpu_torch import G1, Fr, msm
from curdleproofs_tpu_torch import curve as hcurve
from curdleproofs_tpu_torch.curve import msm_host
from curdleproofs_tpu_torch.fields import FQ_MOD, FR_MOD
from curdleproofs_tpu_torch.ops import cuda_g1
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import gather as ogather
from curdleproofs_tpu_torch.ops import glv as oglv
from curdleproofs_tpu_torch.ops import modarith as ma
from curdleproofs_tpu_torch.ops import msm as omsm
from curdleproofs_tpu_torch.ops import scan as oscan
from curdleproofs_tpu_torch.ops import stream_scan as ostream
from curdleproofs_tpu_torch.ops import vector as ovec
from curdleproofs_tpu_torch.ops.fieldspec import FQ_SPEC, from_reference, ints_to_limbs
from curdleproofs_tpu_torch.utils.profiling import metrics

# Least-time model of the card (NVIDIA H100 SXM data sheet): HBM3 at
# 3.35 TB/s; 32-bit integer multiply-adds at half the 67 TFLOP/s fp32 rate's
# instruction count (64 INT32 lanes per SM against 128 FP32 lanes), i.e.
# 67e12 / 2 / 2 instructions per second.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 4
# 32-bit multiplies of one Montgomery product over 12 words: a*b, m*p, and
# the 12 quotient words m
MULS_PER_MONT = 12 * 12 * 2 + 12
REPS = 3  # timed msm() calls after the warm-up
MONT_PER_OP = {"dbl": 7, "madd": 11, "jadd": 16}  # Montgomery products per point operation
KERNELS_CU = "curdleproofs_tpu_torch/csrc/kernels.cu"
LADDERS_CU = "curdleproofs_tpu_torch/csrc/ladders.cu"


PHASE_SECONDS = {}
T_START = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed_phase(name, fn, *args):
    """Run one phase and keep its wall seconds for the closing `seconds` line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 2)
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def progression_bases(a: int, d: int, e: int, n: int):
    """[(a + i*d + i*i*e)*G for i < n] by two running Jacobian adds a point
    and one batched inversion: no per-point scalar multiplication.

    The quadratic term matters. With P_i = (a + i*d)*G alone, sums of three
    bases land on a fourth (P_i + P_j - P_k = P_{i+j-k}), the no-doubling
    scan meets p == q, and the MSM measures its redo instead of its fast
    path. i + j - k = m and i^2 + j^2 - k^2 = m^2 only have trivial
    solutions."""
    g = G1()
    acc = (g * Fr(a))._jacobian()
    step = (g * Fr((d + e) % FR_MOD))._jacobian()  # P_1 - P_0
    two_e = (g * Fr(2 * e % FR_MOD))._jacobian()
    jac = []
    for _ in range(n):
        jac.append(acc)
        acc = hcurve._jadd(acc, step)
        step = hcurve._jadd(step, two_e)
    p = FQ_MOD
    pref = [1] * (n + 1)
    for i, (_, _, z) in enumerate(jac):
        if z == 0:
            raise ValueError("progression hit the identity; pick another seed")
        pref[i + 1] = pref[i] * z % p
    inv = pow(pref[n], -1, p)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        x, y, z = jac[i]
        zinv = inv * pref[i] % p
        inv = inv * z % p
        z2 = zinv * zinv % p
        out[i] = G1(x * z2 % p, y * z2 % p * zinv % p)
    return out


def dlog(coef, i: int) -> int:
    """Discrete log of progression base i."""
    a, d, e = coef
    return (a + i * d + i * i * e) % FR_MOD


def dlog_expect(coef, scalars, start: int = 0) -> G1:
    """sum s_j * P_{start + j}, from the discrete logs."""
    k = sum(s.v * dlog(coef, start + j) for j, s in enumerate(scalars)) % FR_MOD
    return G1() * Fr(k)


def rand_scalar(rng) -> int:
    return int.from_bytes(rng.bytes(32), "little") % FR_MOD


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms over `iters` launches, after one
    warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def wall_ms(fn, dev) -> tuple:
    """(result, wall ms) of one fn() call ending in a synchronise."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(got, want) -> int:
    """Largest absolute difference over a pair (or pairs) of integer tensors."""
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f"shape mismatch {tuple(g.shape)} vs {tuple(w.shape)}")
        if g.numel():
            worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return worst


# ---------------------------------------------------------------------------
# phase: kernels at small shapes, edge lanes
# ---------------------------------------------------------------------------


def ladder_calls(ap, sc, dev):
    """name -> (kernel call, plain call, launches of the name per call) for
    the four ladders on affine points `ap` and (16, m) scalar limbs `sc`
    (host numpy). On CPU tensors the first call is the wrapper's plain path."""
    s1, neg1, s2 = oglv.decompose(sc.astype(np.uint64))
    glv_args = (ap, from_reference(s1, dev), from_reference(neg1, dev), from_reference(s2, dev))
    sc_d = from_reference(sc, dev)
    calls = {}
    for w in (3, 4):
        calls[f"ladder_glv_w{w}"] = (
            lambda w=w: og.scalar_mul_glv(*glv_args, w=w),
            lambda w=w: og._scalar_mul_glv_plain(*glv_args, w=w),
        )
    calls["ladder_w3"] = (lambda: og.scalar_mul(ap, sc_d), lambda: og._scalar_mul_w3_plain(ap, sc_d))
    calls["ladder_w1"] = (
        lambda: og.scalar_mul_w1(ap, sc_d),
        lambda: og._scalar_mul_plain(ap, sc_d, acc0=og._jzero(ap.x)),
    )
    return calls, (s1, neg1, s2)


def ladder_edge_checks(bases, dev, rng, m):
    """The four ladders on m lanes: the edge scalars on lanes of their own,
    an identity base, two equal bases, uniform scalars on the rest (about
    half of those have a negative k1). Each kernel against its plain version
    on all three coordinates, and against the host's P * s."""
    edges = list(oglv.EDGE_SCALARS)
    ks = edges + [rand_scalar(rng) for _ in range(m - len(edges))]
    pts = list(bases[:m])
    pts[len(edges)] = G1.identity()
    pts[len(edges) + 2] = pts[len(edges) + 1]
    want = [p * Fr(k) for p, k in zip(pts, ks)]
    ap = og.pack_points(pts, dev)
    sc = np.asarray(ints_to_limbs(ks, 16), dtype=np.uint32)
    calls, (_s1, neg1, _s2) = ladder_calls(ap, sc, dev)
    out = {"m": m, "negative_k1_lanes": int(neg1.sum())}
    for name, (got_fn, want_fn) in calls.items():
        before = cuda_g1.launch_counts[name]
        got, ms_first = wall_ms(got_fn, dev)
        launched = cuda_g1.launch_counts[name] - before
        plain, plain_ms = wall_ms(want_fn, dev)
        out[name] = {
            "equal": max_abs_err(list(got), list(plain)) == 0,
            "host_check": og.jpoints_to_host(got) == want,
            "launched": launched,
            "ms": cuda_ms(got_fn, 3) if dev.type == "cuda" else ms_first,
            "plain_ms": plain_ms,
        }
    return out


def phase_kernels(bases, dev, rng, m_ladder):
    out = {"phase": "kernels"}
    m = min(1024, len(bases))
    pts = list(bases[:m])
    ap = og.pack_points(pts, dev)
    # q: the same points shifted by one, with edge lanes written in
    qs = pts[1:] + pts[:1]
    qs[3] = pts[3]  # P + P
    qs[4] = -pts[4]  # P + (-P)
    qs[5] = G1.identity()
    aq = og.pack_points(qs, dev)
    # Jacobian representatives with z != 1: (x z^2, y z^3, z), z taken from
    # other lanes' coordinates (nonzero field elements in Montgomery form)
    def rescale(aff, z):
        z2 = ma.mont_sqr(FQ_SPEC, z)
        return og.JPoints(
            ma.mont_mul(FQ_SPEC, aff.x, z2),
            ma.mont_mul(FQ_SPEC, aff.y, ma.mont_mul(FQ_SPEC, z2, z)),
            z.clone(),
        )

    pj = rescale(ap, torch.roll(ap.x, 1, dims=-1))
    qj = rescale(aq, torch.roll(ap.y, 2, dims=-1))
    qj.z[:, 5] = 0  # q at infinity (aq.inf[5] is set already)
    pj.z[:, 6] = 0  # p at infinity
    pj.z[:, 7] = 0  # both at infinity
    qj.z[:, 7] = 0
    aq.inf[7] = True
    point = {}
    if dev.type == "cuda":
        for name, got, want in (
            ("jadd", lambda: cuda_g1.jadd(pj, qj), lambda: og._jadd_formulas(pj, qj)),
            ("jdbl", lambda: cuda_g1.jdbl(pj), lambda: og._jdbl_formulas(pj)),
            ("jmadd", lambda: cuda_g1.jmadd(pj, aq), lambda: og._jmadd_formulas(pj, aq)),
        ):
            g, w = got(), want()
            err = max_abs_err(list(g), list(w))
            point[name] = {
                "equal": err == 0,
                "ms": cuda_ms(got, 5),
                "plain_ms": wall_ms(want, dev)[1],
            }
    out["point_op"] = point

    # gather: random table, indices from -3 to N + 2
    R, W, N, M = 49, 2, 200, 300
    table = torch.from_numpy(rng.integers(0, 1 << 16, (R, W, N)).astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(-3, N + 3, (W, M)).astype(np.int32)).to(dev)
    g = ogather.gather_u32(table, idx)
    w = ogather.gather_u32_ref(table, idx)
    gs = ogather.gather_u32_shared(table[:, 0].contiguous(), idx)
    ws = ogather.gather_u32_ref(table[:, :1].expand(R, W, N), idx)
    safe = idx.clamp(0, N - 1).to(torch.int64).unsqueeze(0).expand(R, -1, -1)
    out["gather_u32"] = {
        "equal": max_abs_err([g, gs], [w, ws]) == 0,
        "ms": cuda_ms(lambda: ogather.gather_u32(table, idx), 5) if dev.type == "cuda" else None,
        "plain_ms": wall_ms(lambda: ogather.gather_u32_ref(table, idx), dev)[1],
        "library_ms": wall_ms(lambda: torch.gather(table, 2, safe), dev)[1],
    }

    # scans: W=2, T=16, L=64, S=32 with infinity records, a forced p == q
    # collision (lane 0 of window 0 sees the same point twice), empty,
    # repeated and out-of-range selection slots
    W, T, L, S = 2, 16, 64, 32
    n = T * L
    rec1 = torch.cat([ap.x, ap.y, ap.inf.unsqueeze(0).to(torch.int32)], dim=0)
    cols = torch.arange(n, device=dev) % m
    rec = rec1[:, cols].reshape(49, 1, T, L).repeat(1, W, 1, 1)
    rec[:, 0, 1, 0] = rec[:, 0, 0, 0]  # collision at step 1
    rec[48, 1, 3, 5] = 1  # an infinity record
    rec[48, 1, 0, 6] = 1  # ... and one at step 0
    rec = rec.reshape(49, W * T * L).contiguous()
    sel = rng.integers(-1, L, (W * T, S)).astype(np.int32)
    sel[0, :4] = [7, 7, -1, L]  # repeated lane, empty, out of range
    sel_d = torch.from_numpy(sel).to(dev)
    got = ostream.scan_records_sel(rec, sel_d, W, T, L, S)
    want = ostream.scan_records_sel_ref(rec, sel_d, W, T, L, S)
    flags = [int(v) for v in got[2].cpu()]
    out["scan_sel"] = {
        "equal": max_abs_err(list(got), list(want)) == 0,
        "flags": flags,
        "collision_flagged": flags == [1, 0],
        "ms": cuda_ms(lambda: ostream.scan_records_sel(rec, sel_d, W, T, L, S), 3)
        if dev.type == "cuda"
        else None,
        "plain_ms": wall_ms(lambda: ostream.scan_records_sel_ref(rec, sel_d, W, T, L, S), dev)[1],
    }
    got = ostream.scan_records(rec, W, T, L)
    want = ostream.scan_records_ref(rec, W, T, L)
    out["scan_full"] = {
        "equal": max_abs_err(list(got), list(want)) == 0,
        "ms": cuda_ms(lambda: ostream.scan_records(rec, W, T, L), 3)
        if dev.type == "cuda"
        else None,
        "plain_ms": wall_ms(lambda: ostream.scan_records_ref(rec, W, T, L), dev)[1],
    }
    out["ladders"] = lad = ladder_edge_checks(bases, dev, rng, m_ladder)
    emit(out)
    bad = [k for k in ("gather_u32", "scan_sel", "scan_full") if not out[k]["equal"]]
    bad += [f"point_op[{k}]" for k, v in point.items() if not v["equal"]]
    for k, v in lad.items():
        if isinstance(v, dict):
            if not (v["equal"] and v["host_check"]):
                bad.append(k)
            if dev.type == "cuda" and v["launched"] != 1:
                fail(f"{k}: the wrapper launched its kernel {v['launched']} times, not once")
    if not 0 < lad["negative_k1_lanes"] < lad["m"]:
        bad.append("ladder lanes lack a negative or a positive k1")
    if not out["scan_sel"]["collision_flagged"]:
        bad.append("scan_sel flags")
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")


# ---------------------------------------------------------------------------
# phases: the MSM through its entry point
# ---------------------------------------------------------------------------


def _counts():
    return dict(cuda_g1.launch_counts)


def _delta(before):
    return {k: cuda_g1.launch_counts[k] - before[k] for k in before}


def phase_msm_main(bases, scalars, coef, dev):
    cuda_g1.reset_launch_counts()
    n = len(bases)
    before = _counts()
    c = omsm.pick_window(n)
    want = dlog_expect(coef, scalars)
    got = msm(bases, scalars, device=dev)  # warm-up, checked
    dlog_ok = got == want
    launches_one = _delta(before)
    sub = list(scalars[:128]) + [Fr(0)] * (n - 128)
    sub_ok = msm(bases, sub, device=dev) == msm_host(list(bases[:128]), list(scalars[:128]))
    metrics().reset()
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        r = msm(bases, scalars, device=dev)
        walls.append(time.perf_counter() - t0)
        dlog_ok = dlog_ok and r == want
    rep = metrics().report()
    # the same MSM at c = 12 (W = 11 windows), the neighbouring window size
    t0 = time.perf_counter()
    c12_ok = msm(bases, scalars, c=12, device=dev) == want
    c12_wall = time.perf_counter() - t0

    def mean_s(name):
        return rep[name]["total_time_s"] / REPS  # a redo would count twice

    split = {k: mean_s(f"msm.stream.{k}") for k in ("host_prep", "device", "combine")}
    split["pack_points_and_rest"] = float(np.mean(walls)) - sum(split.values())
    n2 = 2 * n
    L = ostream.pick_lanes(n2)
    emit(
        {
            "phase": "msm_2e16",
            "n": n,
            "c": c,
            "W": -(-130 // c),
            "L": L,
            "T": n2 // L,
            "dlog_check": dlog_ok,
            "first128_check": sub_ok,
            "launches_per_msm": launches_one,
            "fast_path": launches_one["scan_full"] == 0,
            "wall_s": {"median": float(np.median(walls)), "min": min(walls), "max": max(walls)},
            "split_s": split,
            "reps": REPS,
            "c12_W11": {"dlog_check": c12_ok, "wall_s": c12_wall},
        }
    )
    if not (dlog_ok and sub_ok and c12_ok):
        fail("msm_2e16 result is wrong")
    for k in ("scan_sel", "gather_u32", "point_op"):
        if dev.type == "cuda" and launches_one[k] == 0:
            fail(f"msm_2e16 never launched {k}")
    return _counts()


def phase_msm_redo(n, dev):
    cuda_g1.reset_launch_counts()
    before = _counts()
    p = G1() * Fr(11)
    got = msm([p] * n, [Fr(7)] * n, device=dev)
    ok = got == G1() * Fr(11 * 7 * n % FR_MOD)
    delta = _delta(before)
    emit({"phase": "msm_redo", "n": n, "oracle_check": ok, "launches": delta})
    if not ok:
        fail("msm_redo result is wrong")
    if dev.type == "cuda" and not (delta["scan_sel"] and delta["scan_full"]):
        fail("msm_redo did not go through scan_sel and then scan_full")
    return _counts()


def phase_msm_split(bases, scalars, coef, dev):
    cuda_g1.reset_launch_counts()
    before = _counts()
    t0 = time.perf_counter()
    got = msm(bases, scalars, device=dev)
    wall = time.perf_counter() - t0
    ok = got == dlog_expect(coef, scalars)
    emit(
        {
            "phase": "msm_split",
            "n": len(bases),
            "slices": -(-len(bases) // omsm.STREAM_SPLIT),
            "dlog_check": ok,
            "wall_s": wall,
            "launches": _delta(before),
        }
    )
    if not ok:
        fail("msm_split result is wrong")
    return _counts()


def _wall_stats(walls):
    return {"median": float(np.median(walls)), "min": min(walls), "max": max(walls)}


def phase_msm_ladder(bases, scalars, coef, dev, small_sizes):
    """msm() through method="auto" at the widest size the ladder branch takes."""
    cuda_g1.reset_launch_counts()
    n = len(bases)
    glv_name = f"ladder_glv_w{cuda_g1.GLV_W}"
    want = dlog_expect(coef, scalars)
    before = _counts()
    dlog_ok = msm(bases, scalars, device=dev) == want  # warm-up, checked
    launches_one = _delta(before)
    sub = list(scalars[:128]) + [Fr(0)] * (n - 128)
    sub_ok = msm(bases, sub, device=dev) == msm_host(list(bases[:128]), list(scalars[:128]))
    metrics().reset()
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        r = msm(bases, scalars, device=dev)
        walls.append(time.perf_counter() - t0)
        dlog_ok = dlog_ok and r == want
    rep = metrics().report()
    split = {k: rep[f"msm.ladder.{k}"]["total_time_s"] / REPS for k in ("pack", "decompose", "device", "readback")}
    split["rest"] = float(np.mean(walls)) - sum(split.values())
    # 4-bit windows: the same MSM through msm_ladder(w=4), the packing outside the clock
    pts = og.pack_points(list(bases), dev)
    sc = np.asarray(ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32)
    before = _counts()
    w4_ok = omsm.msm_ladder(pts, sc, w=4) == want
    w4_launches = _delta(before)
    w_walls = {}
    for w in (3, 4):
        got, ms = wall_ms(lambda w=w: omsm.msm_ladder(pts, sc, w=w), dev)
        w_walls[f"w{w}"] = ms / 1e3
        w4_ok = w4_ok and got == want
    # the streaming Pippenger at the same n: one warm-up, then REPS timed calls
    stream_ok = msm(bases, scalars, method="stream", device=dev) == want
    s_walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        stream_ok = msm(bases, scalars, method="stream", device=dev) == want and stream_ok
        s_walls.append(time.perf_counter() - t0)
    small = {}
    for k in small_sizes:
        before = _counts()
        ok = msm(bases[:k], scalars[:k], device=dev) == dlog_expect(coef, scalars[:k])
        small[str(k)] = {"dlog_check": ok, "launches": {a: b for a, b in _delta(before).items() if b}}
    emit(
        {
            "phase": "msm_ladder",
            "n": n,
            "glv_w": cuda_g1.GLV_W,
            "dlog_check": dlog_ok,
            "first128_check": sub_ok,
            "launches_per_msm": launches_one,
            "wall_s": _wall_stats(walls),
            "split_s": split,
            "reps": REPS,
            "w4": {"dlog_check": w4_ok, "launches": w4_launches},
            "msm_ladder_wall_s_packed_inputs": w_walls,
            "stream_same_n": {"dlog_check": stream_ok, "wall_s": _wall_stats(s_walls)},
            "small": small,
        }
    )
    if not (dlog_ok and sub_ok and w4_ok and stream_ok and all(v["dlog_check"] for v in small.values())):
        fail("msm_ladder result is wrong")
    if dev.type == "cuda":
        if launches_one[glv_name] != 1 or launches_one["point_op"] == 0:
            fail(f"msm() at n = {n} did not go through one {glv_name} launch and the point kernel")
        if launches_one["scan_sel"] or launches_one["gather_u32"]:
            fail(f"msm() at n = {n} went to the streaming Pippenger")
        if w4_launches["ladder_glv_w4"] != 1:
            fail("msm_ladder(w=4) did not launch ladder_glv_w4")
    return _counts()


def phase_ladder_segmented(bases, scalars, coef, dev, K, m):
    """K independent m-lane MSMs as one launch."""
    cuda_g1.reset_launch_counts()
    n = K * m
    pts = og.pack_points(list(bases[:n]), dev)
    sc = np.asarray(ints_to_limbs([s.v for s in scalars[:n]], 16), dtype=np.uint32)
    want = [dlog_expect(coef, scalars[k * m : (k + 1) * m], start=k * m) for k in range(K)]
    got, _ = wall_ms(lambda: omsm.msm_ladder_segmented(pts, sc, K), dev)  # warm-up, checked
    launches_one = _counts()
    metrics().reset()
    walls = []
    ok = got == want
    for _ in range(REPS):
        got, ms = wall_ms(lambda: omsm.msm_ladder_segmented(pts, sc, K), dev)
        walls.append(ms / 1e3)
        ok = ok and got == want
    rep = metrics().report()
    emit(
        {
            "phase": "ladder_segmented",
            "K": K,
            "m": m,
            "oracle_check": ok,
            "launches_per_call": launches_one,
            "wall_s_packed_inputs": _wall_stats(walls),
            "split_s": {k: rep[f"msm.ladder_seg.{k}"]["total_time_s"] / REPS for k in ("decompose", "device", "readback")},
        }
    )
    if not ok:
        fail("ladder_segmented result is wrong")
    if dev.type == "cuda" and launches_one[f"ladder_glv_w{cuda_g1.GLV_W}"] != 1:
        fail("ladder_segmented did not run as one ladder launch")
    return _counts()


def _sum_points(points, dev) -> G1:
    """Sum of a list of host points, on the device (one tree reduce)."""
    res = oscan.tree_reduce_hybrid(og.lift(og.pack_points(list(points), dev)))
    return og.jpoints_to_host(res)[0]


def phase_vector_ops(bases, scalars, coef, dev, n_small, n_big, n_sample, rng):
    """The vector ops at the width of one shuffle and at the lockstep
    prover's width. Operands: a = bases[:n], b = bases[n:2n]."""
    cuda_g1.reset_launch_counts()
    out = {"phase": "vector_ops"}
    gamma, k_common = Fr(rand_scalar(rng)), Fr(rand_scalar(rng))
    bad = []
    for n in (n_small, n_big):
        a, b, sc = list(bases[:n]), list(bases[n : 2 * n]), list(scalars[:n])
        da = sum(dlog(coef, i) for i in range(n))
        db = sum(dlog(coef, n + i) for i in range(n))
        ops = {
            "scale_points": (
                lambda: ovec.scale_points(a, sc, device=dev),
                lambda i: a[i] * sc[i],
                sum(s.v * dlog(coef, i) for i, s in enumerate(sc)),
            ),
            "scale_points_common": (
                lambda: ovec.scale_points_common(a, k_common, device=dev),
                lambda i: a[i] * k_common,
                k_common.v * da,
            ),
            "fold_points": (
                lambda: ovec.fold_points(a, b, gamma, device=dev),
                lambda i: a[i] + b[i] * gamma,
                da + gamma.v * db,
            ),
            "fold_points_multi": (
                lambda: ovec.fold_points_multi(a, b, sc, device=dev),
                lambda i: a[i] + b[i] * sc[i],
                da + sum(s.v * dlog(coef, n + i) for i, s in enumerate(sc)),
            ),
            "add_points": (
                lambda: ovec.add_points(a, b, device=dev),
                lambda i: a[i] + b[i],
                da + db,
            ),
        }
        sample = range(n) if n <= n_sample else sorted(rng.choice(n, n_sample, replace=False).tolist())
        res = {}
        for name, (fn, host, total_dlog) in ops.items():
            before = _counts()
            got, ms = wall_ms(fn, dev)
            launches = {k: v for k, v in _delta(before).items() if v}
            elem_ok = len(got) == n and all(got[i] == host(i) for i in sample)
            sum_ok = _sum_points(got, dev) == G1() * Fr(total_dlog % FR_MOD)
            res[name] = {"elements_checked": len(sample), "elements_ok": elem_ok, "sum_ok": sum_ok,
                         "wall_s": ms / 1e3, "launches": launches}
            if not (elem_ok and sum_ok):
                bad.append(f"{name}[{n}]")
        out[str(n)] = res
    # the bitwise ladder cross-checks the windowed one, every lane, at n_big
    pts = og.pack_points(list(bases[:n_big]), dev)
    sc_d = og.pack_scalars(list(scalars[:n_big]), dev)
    out["w1_cross_check"] = og.jpoints_to_host(og.scalar_mul_w1(pts, sc_d)) == og.jpoints_to_host(
        og.scalar_mul(pts, sc_d)
    )
    emit(out)
    if bad or not out["w1_cross_check"]:
        fail(f"vector ops disagree with the host: {bad}, w1 cross-check {out['w1_cross_check']}")
    if dev.type == "cuda":
        for name, kernel in (("scale_points", "ladder_w3"), ("fold_points", "ladder_w3"), ("add_points", "point_op")):
            if not out[str(n_big)][name]["launches"].get(kernel):
                fail(f"{name} never launched {kernel}")
    return _counts()


# ---------------------------------------------------------------------------
# phase: each kernel at the main path's shapes, timed, beside its bound
# ---------------------------------------------------------------------------


def glv_ladder_products(s1, s2, w: int) -> int:
    """Montgomery products the GLV ladder needs on these half-scalars: the
    table chain, the endomorphism images, w doublings an iteration, and one
    add per NON-ZERO digit (a zero digit adds nothing)."""
    iters, bits = (43, 129) if w == 3 else (33, 132)
    lanes = s1.shape[1]
    half = (1 << (w - 1)) - 1
    table = half * (MONT_PER_OP["dbl"] + MONT_PER_OP["madd"]) + (1 << w) - 1
    adds = sum(int(np.count_nonzero(omsm.host_digits(s, w, bits=bits))) for s in (s1, s2))
    return lanes * (table + iters * w * MONT_PER_OP["dbl"]) + adds * MONT_PER_OP["jadd"]


def phase_kernel_times(bases, scalars, dev, launches, by_phase, n_glv, n_vec, coef):
    """Rebuild the tensors the main paths hand each kernel (same host prep,
    same records) and compare kernel and plain version on them."""
    n = len(bases)
    c = omsm.pick_window(n)
    pts = og.pack_points(list(bases), dev)
    sc = np.asarray(ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32)
    s1, neg1, s2 = oglv.decompose(sc.astype(np.uint64))
    digits = omsm.host_digits(np.concatenate([s1, s2], axis=1).astype(np.uint32), c, bits=130)
    W, n2 = digits.shape
    L = ostream.pick_lanes(n2)
    T = n2 // L
    order_cm, _bidx, lidx, e = omsm.stream_host_prep(digits, c, L)
    for S in omsm.SEL_SLOT_OPTIONS:
        sel, bpos = omsm._build_sel(e, T, S)
        if sel is not None:
            break
    else:
        fail("selection slots overflow on uniform scalars")
    packed = omsm._glv_stream_packed(pts.x, pts.y, pts.inf, from_reference(neg1, dev)).contiguous()
    idx_d, sel_d = from_reference(order_cm, dev), from_reference(sel, dev)
    bpos_d, lidx_d = from_reference(bpos, dev), from_reference(lidx, dev)
    rows = []

    stream_shape = {"W": W, "T": T, "L": L, "S": S, "n": n2}

    def row(name, replaces, got_fn, want_fn, ops, nbytes, library_fn=None, iters=5,
            source=KERNELS_CU, shape=stream_shape):
        got, ms_first = wall_ms(got_fn, dev)
        want, plain_ms = wall_ms(want_fn, dev)
        err = max_abs_err(list(got) if isinstance(got, tuple) else got,
                          list(want) if isinstance(want, tuple) else want)
        t_ops, t_bytes = ops / INT32_MAD_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[name],
                "launches_by_phase": {ph: c[name] for ph, c in by_phase.items() if c[name]},
                "max_abs_err": err,
                "ms": cuda_ms(got_fn, iters) if dev.type == "cuda" else ms_first,
                "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": cuda_ms(library_fn, iters) if library_fn and dev.type == "cuda" else None,
                "shape": shape,
            }
        )
        return got

    # gather_u32: the sorted-order gather of the point records
    tab3 = packed.unsqueeze(1)
    flat_idx = idx_d.reshape(1, W * n2)
    lib_idx = flat_idx.to(torch.int64).unsqueeze(0).expand(49, -1, -1)
    g = row(
        "gather_u32",
        "curdleproofs_tpu/ops/gather.py:82",
        lambda: ogather.gather_u32(tab3, flat_idx),
        lambda: ogather.gather_u32_ref(tab3, flat_idx),
        ops=0,
        nbytes=4 * (packed.numel() + flat_idx.numel() + 49 * W * n2),
        library_fn=lambda: torch.gather(tab3, 2, lib_idx),
    )
    rec = g.reshape(49, W * T * L)
    madd_ops = W * n2 * MONT_PER_OP["madd"] * MULS_PER_MONT
    bsel, totals, _flags = row(
        "scan_sel",
        "curdleproofs_tpu/ops/stream_scan.py:163",
        lambda: ostream.scan_records_sel(rec, sel_d, W, T, L, S),
        lambda: ostream.scan_records_sel_ref(rec, sel_d, W, T, L, S),
        ops=madd_ops,
        nbytes=4 * (rec.numel() + sel_d.numel() + 72 * W * T * S + 72 * W * L + W),
        iters=3,
    )
    row(
        "scan_full",
        "curdleproofs_tpu/ops/stream_scan.py:93",
        lambda: ostream.scan_records(rec, W, T, L),
        lambda: ostream.scan_records_ref(rec, W, T, L),
        ops=madd_ops,
        nbytes=4 * (rec.numel() + 72 * W * T * L + 72 * W * L),
        iters=3,
    )
    # point_op: the boundary stitch, local prefix + lane offset, (24, W, B-1)
    lane_tab = totals  # any (72, W, L) table of valid points serves as offsets
    bl = omsm._split72(ogather.gather_u32(bsel, bpos_d))
    lo = omsm._split72(ogather.gather_u32(lane_tab, lidx_d))
    m = bl.x[0].numel()
    row(
        "point_op",
        "curdleproofs_tpu/ops/pallas_g1.py:130",
        lambda: tuple(cuda_g1.jadd(bl, lo)) if dev.type == "cuda" else tuple(og.jadd(bl, lo)),
        lambda: tuple(og._jadd_formulas(bl, lo)),
        ops=m * MONT_PER_OP["jadd"] * MULS_PER_MONT,
        nbytes=4 * 24 * 9 * m,
    )
    # the four ladders: the GLV pair at the width of the widest ladder msm(),
    # the Fr ladders at the width of the large vector ops
    lanes = {"ladder_glv_w3": n_glv, "ladder_glv_w4": n_glv, "ladder_w3": n_vec, "ladder_w1": n_vec}
    replaces = {
        "ladder_glv_w3": "curdleproofs_tpu/ops/pallas_g1.py:338",
        "ladder_glv_w4": "curdleproofs_tpu/ops/pallas_g1.py:464",
        "ladder_w3": "curdleproofs_tpu/ops/pallas_g1.py:258",
        "ladder_w1": "curdleproofs_tpu/ops/pallas_g1.py:198",
    }
    rows_in = {"ladder_glv_w3": 48 + 2 + 18, "ladder_glv_w4": 48 + 2 + 18, "ladder_w3": 7 * 72 + 16, "ladder_w1": 48 + 1 + 16}
    dbl, jadd, madd = (MONT_PER_OP[k] for k in ("dbl", "jadd", "madd"))
    n_check = min(64, n_vec)
    oracle = {}
    for m in sorted({n_glv, n_vec}, reverse=True):
        ap = og.pack_points(list(bases[:m]), dev)
        sc_m = sc[:, :m]
        calls, (h1, _neg, h2) = ladder_calls(ap, sc_m, dev)
        products = {
            "ladder_glv_w3": glv_ladder_products(h1, h2, 3),
            "ladder_glv_w4": glv_ladder_products(h1, h2, 4),
            "ladder_w3": m * 85 * 3 * dbl
            + int(np.count_nonzero(omsm.host_digits(sc_m, 3, bits=255))) * jadd,
            "ladder_w1": m * 255 * dbl + int(np.count_nonzero(omsm.host_digits(sc_m, 1, bits=255))) * madd,
        }
        for name, (got_fn, want_fn) in calls.items():
            if lanes[name] != m:
                continue
            got = row(
                name,
                replaces[name],
                lambda f=got_fn: tuple(f()),
                lambda f=want_fn: tuple(f()),
                ops=products[name] * MULS_PER_MONT,
                nbytes=4 * m * (rows_in[name] + 72),
                iters=3,
                source=LADDERS_CU,
                shape={"lanes": m, "montgomery_products": products[name]},
            )
            host = og.jpoints_to_host(og.JPoints(*(g[:, :n_check] for g in got)))
            oracle[name] = host == [
                G1() * Fr(scalars[i].v * dlog(coef, i) % FR_MOD) for i in range(n_check)
            ]
    emit(
        {
            "phase": "kernel_times",
            "ladder_oracle_check_lanes": n_check,
            "ladder_oracle_check": oracle,
            # not a kernel of this package yet: the least time of ONE stage of the JAX
            # package's row-local gather (ops/gather.py:265) over this MSM's records:
            # the indices read once, 49 rows read and 49 written per record
            "rowwise_gather_stage_bound_ms": 4 * W * n2 * (1 + 49 + 49) / HBM_BYTES_PER_S * 1e3,
        }
    )
    emit({"kernels": rows})
    if not all(oracle.values()):
        fail(f"ladders disagree with the discrete-log oracle at the main path's shapes: {oracle}")
    bad = [r["name"] for r in rows if r["max_abs_err"] != 0]
    if bad:
        fail(f"kernels disagree with their plain versions at the main path's shapes: {bad}")
    if dev.type == "cuda":
        idle = [r["name"] for r in rows if r["launches"] == 0]
        if idle:
            fail(f"the main path never launched: {idle}")


def ptxas_report() -> int:
    """What ptxas says of each kernel: registers, stack frame (local memory),
    spills. Needs nvcc, no card."""
    import tempfile

    for unit in cuda_g1.ENTRY_POINTS:
        with tempfile.TemporaryDirectory() as tmp:
            cmd = cuda_g1.nvcc_command(unit, f"{tmp}/out.so", extra=("-Xptxas", "-v"))
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return 1
        entry, stats = None, {}
        for line in proc.stderr.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and "stack frame" in line and entry not in stats:
                stats[entry] = {"frame": line.strip()}
            elif entry and "Used" in line and "registers" in line:
                stats[entry]["used"] = line.split(":", 1)[1].strip()
        emit({"phase": "ptxas", "source": unit, "nvcc_s": seconds, "kernels": stats})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--rehearse-cpu",
        action="store_true",
        help="tiny sizes on the CPU with the plain versions; prints no result, exits 2",
    )
    ap.add_argument(
        "--ptxas",
        action="store_true",
        help="compile each source with -Xptxas -v, print registers and stack bytes per kernel, and stop",
    )
    args = ap.parse_args()
    if args.ptxas:
        return ptxas_report()
    rng = np.random.default_rng(args.seed)

    global REPS
    if args.rehearse_cpu:
        dev = torch.device("cpu")
        omsm.STREAM_MIN, omsm.STREAM_SPLIT, omsm.SEL_MIN_N = 64, 128, 256
        ostream._LANES = 16
        n_main, n_redo = 128, 128
        n_ladder, small_sizes, seg, m_edge = 63, (17, 20), (4, 4), 20
        n_vec_small, n_vec_big, n_sample = 6, 12, 4
        REPS = 1
        gpu_line = "cpu rehearsal"
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        dev = torch.device("cuda")
        n_main, n_redo = 1 << 16, 1 << 14
        n_ladder, small_sizes, seg, m_edge = omsm.STREAM_MIN - 1, (17, 124, 4096), (64, 128), 256
        n_vec_small, n_vec_big, n_sample = 124, 8192, 256
        gpu_line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        t0 = time.perf_counter()
        cuda_g1.lib()
        emit(
            {
                "phase": "device",
                "gpu": gpu_line,
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "build_s": cuda_g1.build_seconds,
                "load_s": time.perf_counter() - t0,
            }
        )
    n_split = n_main + n_main // 2 + 5

    coef = tuple(rand_scalar(rng) for _ in range(3))
    t0 = time.perf_counter()
    bases = progression_bases(*coef, n_split)
    scalars = [Fr(rand_scalar(rng)) for _ in range(n_split)]
    emit({"phase": "inputs", "n": n_split, "seed": args.seed, "seconds": time.perf_counter() - t0})

    timed_phase("kernels", phase_kernels, bases, dev, rng, m_edge)

    # the main paths: each sets the launch counts to 0 just before it drives
    # its entry points and returns them as read just after
    by_phase = {
        "msm_2e16": timed_phase("msm_2e16", phase_msm_main, bases[:n_main], scalars[:n_main], coef, dev),
        "msm_redo": timed_phase("msm_redo", phase_msm_redo, n_redo, dev),
        "msm_split": timed_phase("msm_split", phase_msm_split, bases, scalars, coef, dev),
        "msm_ladder": timed_phase(
            "msm_ladder", phase_msm_ladder, bases[:n_ladder], scalars[:n_ladder], coef, dev, small_sizes
        ),
        "ladder_segmented": timed_phase(
            "ladder_segmented", phase_ladder_segmented, bases, scalars, coef, dev, *seg
        ),
        "vector_ops": timed_phase(
            "vector_ops", phase_vector_ops, bases, scalars, coef, dev, n_vec_small, n_vec_big, n_sample, rng
        ),
    }
    launches = {k: sum(c[k] for c in by_phase.values()) for k in cuda_g1.KERNEL_NAMES}

    timed_phase(
        "kernel_times", phase_kernel_times, bases[:n_main], scalars[:n_main], dev, launches, by_phase,
        n_ladder, n_vec_big, coef,
    )
    emit({"phase": "seconds", "per_phase": PHASE_SECONDS, "total": time.perf_counter() - T_START})

    if args.rehearse_cpu:
        print("chip_smoke: CPU rehearsal finished; no result without a CUDA device", file=sys.stderr)
        return 2
    print(gpu_line, flush=True)
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
