#!/usr/bin/env python3
"""GPU smoke run of curdleproofs_tpu_torch: build the CUDA kernels from the
sources in this checkout, hold each against its plain PyTorch version, and
drive the streaming Pippenger MSM end to end through `msm()`.

    python3 chip_smoke.py            # needs one CUDA device; exits 0 on success

Phases, each printing one JSON line; any failure exits non-zero:

  device     card name and power limit (nvidia-smi), kernel build time
  kernels    the four kernels vs their plain versions at small shapes with
             edge lanes (identity, P+P, P+(-P), a forced p == q collision in
             scan_sel, empty and repeated selection slots, out-of-range
             gather indices) — integer equality
  msm_2e16   msm() at n = 2^16: bases P_i = (a + i*d + i^2*e)*G, uniform scalars;
             result == (sum s_i*dlog(P_i) mod r)*G, and first-128-scalars-only
             == msm_host; wall times and the host-prep / device / combine split
  msm_redo   all-equal bases and scalars force the doubling flag; the result
             equals the oracle and the complete scan launched
  msm_split  n = 3*2^15 + 5: two STREAM_SPLIT slices, the second padded
  kernel_times  each kernel at the shapes msm_2e16 gives it vs its plain
             version (equality), timed with CUDA events, beside the least
             time the card could take; launch counts are those of the three
             msm phases above (set to 0 before them, read after them)

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
from curdleproofs_tpu_torch.ops import stream_scan as ostream
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
MONT_PER_OP = {"madd": 11, "jadd": 16}  # Montgomery products per point operation


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def dlog_expect(coef, scalars) -> G1:
    a, d, e = coef
    k = sum(s.v * (a + i * d + i * i * e) for i, s in enumerate(scalars)) % FR_MOD
    return G1() * Fr(k)


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


def phase_kernels(bases, dev, rng):
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
    emit(out)
    bad = [k for k in ("gather_u32", "scan_sel", "scan_full") if not out[k]["equal"]]
    bad += [f"point_op[{k}]" for k, v in point.items() if not v["equal"]]
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


def phase_msm_redo(n, dev):
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


def phase_msm_split(bases, scalars, coef, dev):
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


# ---------------------------------------------------------------------------
# phase: each kernel at the main path's shapes, timed, beside its bound
# ---------------------------------------------------------------------------


def phase_kernel_times(bases, scalars, dev, launches):
    """Rebuild the tensors msm() hands each kernel at this n (same host prep,
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

    def row(name, replaces, got_fn, want_fn, ops, nbytes, library_fn=None, iters=5):
        got, ms_first = wall_ms(got_fn, dev)
        want, plain_ms = wall_ms(want_fn, dev)
        err = max_abs_err(list(got) if isinstance(got, tuple) else got,
                          list(want) if isinstance(want, tuple) else want)
        t_ops, t_bytes = ops / INT32_MAD_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(
            {
                "name": name,
                "route": "cuda",
                "source": "curdleproofs_tpu_torch/csrc/kernels.cu",
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": err,
                "ms": cuda_ms(got_fn, iters) if dev.type == "cuda" else ms_first,
                "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": cuda_ms(library_fn, iters) if library_fn and dev.type == "cuda" else None,
                "shape": {"W": W, "T": T, "L": L, "S": S, "n": n2},
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
    emit({"kernels": rows})
    bad = [r["name"] for r in rows if r["max_abs_err"] != 0]
    if bad:
        fail(f"kernels disagree with their plain versions at the main path's shapes: {bad}")
    if dev.type == "cuda":
        idle = [r["name"] for r in rows if r["launches"] == 0]
        if idle:
            fail(f"the main path never launched: {idle}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--rehearse-cpu",
        action="store_true",
        help="tiny sizes on the CPU with the plain versions; prints no result, exits 2",
    )
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)

    if args.rehearse_cpu:
        dev = torch.device("cpu")
        omsm.STREAM_MIN, omsm.STREAM_SPLIT, omsm.SEL_MIN_N = 64, 128, 256
        ostream._LANES = 16
        n_main, n_redo = 128, 128
        gpu_line = "cpu rehearsal"
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        dev = torch.device("cuda")
        n_main, n_redo = 1 << 16, 1 << 14
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

    coef = tuple(int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(3))
    t0 = time.perf_counter()
    bases = progression_bases(*coef, n_split)
    scalars = [
        Fr(int.from_bytes(rng.bytes(32), "little") % FR_MOD) for _ in range(n_split)
    ]
    emit({"phase": "inputs", "n": n_split, "seed": args.seed, "seconds": time.perf_counter() - t0})

    phase_kernels(bases, dev, rng)

    cuda_g1.reset_launch_counts()  # the main path starts here
    phase_msm_main(bases[:n_main], scalars[:n_main], coef, dev)
    phase_msm_redo(n_redo, dev)
    phase_msm_split(bases, scalars, coef, dev)
    launches = _counts()  # ... and ends here

    phase_kernel_times(bases[:n_main], scalars[:n_main], dev, launches)

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
