#!/usr/bin/env python3
"""GPU smoke run of curdleproofs_tpu_torch: build the CUDA kernels from the
sources in this checkout, hold each against its plain PyTorch version, and
drive the package end to end through its entry points: `msm()` on the
streaming Pippenger (direct and routed gather), on the GLV ladder and on the
sort-based engines, the segmented ladder MSM, the vector ops, the Whisk
protocol (one proof on the host backend; batched verification, its tracker
decode and lockstep batch proving on the card), and the sharded MSMs of
`parallel/` in a world of one process and of four sharing the card.

    python3 chip_smoke.py            # needs one CUDA device; exits 0 on success

Phases, each printing one JSON line; any failure exits non-zero:

  device     card name and power limit (nvidia-smi), kernel build time, the
             native host library's build time and OpenMP threads
  kernels    the thirteen kernels vs their plain versions at small shapes with
             edge lanes (point_op and the four ladders at every thread group
             G = 1, 2, 4; point_strided's scan schedule at 3 x 256 lanes, six
             levels, at every group; identity, P+P, P+(-P), a forced p == q collision in
             scan_sel at split 1 and at the default split, the two equal as
             points; scan_full the same, with a lane of one point at every
             step; empty and repeated selection slots, out-of-range gather
             indices, a ragged M, shared and per-window tables, both gather
             layouts; rowwise_gather at one group with a ragged M and
             at the three stage shapes of the routed gather, per chunk of two
             windows and with all windows in one launch, routed_gather
             against packed[:, src]; for the four ladders 256 lanes with the edge
             scalars 0, 1, r-1, lambda, lambda+-1, 2^128, 14*lambda, ..., an
             identity base, two equal bases, negative k1, for ladder_w1 also
             r+2 (its last add doubles), all three coordinates and the host's
             P*s; the three field kernels at 64 lanes: decompress with x = 0
             of both signs, three x without a root, x = p - 1, compress on
             its output, glv_records with identity lanes and mixed neg1) —
             integer equality
  host_native  msm_prep_batch at n = 2^16, c = 13, L = 512 array-equal to the
             numpy chain, and both times
  msm_2e16   msm() at n = 2^16: bases P_i = (a + i*d + i^2*e)*G, uniform scalars;
             result == (sum s_i*dlog(P_i) mod r)*G, and first-128-scalars-only
             == msm_host; wall times and the host-prep / device / combine split
  msm_redo   all-equal bases and scalars force the doubling flag; the result
             equals the oracle and the complete scan launched
  msm_split  n = 3*2^15 + 5: two STREAM_SPLIT slices, the second padded
  msm_routed msm_pippenger_stream(routed=True) at n = 2^16 (r = 512, c = 256,
             W = 10, chunks of two windows): == the discrete-log oracle,
             first 128 == msm_host, wall times and spans (route solve, native
             prep, device, combine), beside the direct gather in turns
  msm_sort   msm(method="pippenger") and msm(method="hostsort") at n = 4096
             (point_strided, point_op and gather_u32 launched)
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
  whisk_single  the Whisk API at ell = 124 (n = 128): a shuffle proof, its
             verification and a tracker proof, REPS times each (wall median,
             min, max), a flipped byte rejected; no kernel launch and no
             device span (n < DEVICE_MIN: the host backend); the proof bytes
             equal those of the pure-Python curve and transcript (the oracle,
             CURDLEPROOFS_TRANSCRIPT_NATIVE=0) under the same seed
  whisk_batch_verify  64 proofs by the thread prover, then one
             AreValidWhiskShuffleProofs: true, false with a flipped byte; the
             merged MSM's engine and width (the streaming Pippenger), the
             spans (decode, transcript replay, dedup, pack, host prep,
             device, combine); scan_sel, gather_u32, point_op and decompress
             launched; then the same call with the decode on the plain chain
             (the decode's spans before and after, in one run)
  decompress the batched verifier's 31,744 tracker points decoded on the
             card (ops.compress, one decompress launch) and by the host C
             decoder: equal; encoded back (batch_compress, one compress
             launch): the input bytes; both times, the decode's spans (parse,
             upload, kernel and readback, unpack_points), the kernel by CUDA
             events, and the kernel path against the host C decoder at
             1,024, 4,096, 8,192 and 31,744 points in turns, with the size
             from which the kernel path wins
  whisk_lockstep_prove  the same 64 proofs by the lockstep prover (64 x
             128-lane segmented MSMs, merged scales and folds): byte for byte
             the thread prover's; ladder_glv_w3, ladder_w3 and point_op
             launched; both walls
  entry      parallel.dryrun.entry(), the single-device entry: one
             Pippenger window-partials step at n = 1024, c = 8 on the card
             (gather_u32, point_strided and point_op launched); the total is the sum of the
             points and the MSM recombined from the 32 bucket sums equals
             msm_host; warm walls
  sharded_world1  the sharded MSM (parallel/) in a world of one process,
             NCCL on the card (a file:// rendezvous in a temporary
             directory): msm_sharded_stream at n = 2^16 (the sel path),
             msm_sharded_ladder at 2^14 - 1 and msm_sharded at 4,096, each
             against the discrete-log oracle (the stream engine also against
             msm()); then REPS walls of each in turns with msm() on the same
             inputs (median, min, max) and the sharded spans (pack, host prep,
             device, collective, combine): the overhead at devices = 1;
             scan_sel, gather_u32, point_op, point_strided (the sort
             engine's scan) and the GLV ladder launched
  sharded_ranks4  gather_u32 and scan_sel at one rank's shapes (2^15 GLV
             lanes, its first window chunk) against their plain versions;
             then four processes spawned on the one card, joined over gloo
             (NCCL refuses two ranks on one card): the same three calls, every
             rank's results equal to each other and to the oracle, the sel
             path on every rank, then dryrun_multichip(4) with its (2, 2)
             dp x sp layout; each rank's walls of the stream call (four ranks
             sharing one card: not a scaling number); launches summed over
             the ranks
  kernel_times  each kernel at the shapes the phases above give it vs its
             plain version (equality), timed with CUDA events, beside the
             least time the card could take; scan_sel at every split (the
             `split_sweep`, lane totals on a sample as points); scan_full at
             every split, two rounds in turns, each bit-equal to the plain
             version at its split (its `split_sweep`); gather_u32
             with its record-major copy, the copy and the kernel alone, the
             other layout, torch.gather and torch.index_select, both layouts
             at the sorted-order gather of n/4 and n/2 (`layout_probe`), and the
             stitch's two gathers in both layouts; rowwise_gather per stage of the
             routed gather at the chunk shape the routed path launches,
             beside torch.gather in five rounds of turns (medians), and the
             transposes between the stages (the same with all windows in one
             launch as an extra field); point_op at every width msm_2e16's
             msm() launches it (recorded in that phase's counted call), each body at
             every thread group in turns, bit-equal to plain, with CUDA-graph
             device times, bounds, launches per msm() and the group the
             wrapper picks (`group_sweep`); point_strided: one chunk of the
             sort engines' prefix scan at 8 windows of 2^19 lanes (27
             launches), bit-equal to its plain twin and to lift ->
             inclusive_scan -> cat, beside that composition's time, and each
             launch alone by CUDA graph beside point_op at its width
             (`per_launch`, `ms_by_kind`); ladder_w3 alone at the two vector
             widths, ladder_w1 at 124, 1,024, 2,048, 3,072, 4,096, 6,144,
             8,192 and 16,383 lanes, and each GLV ladder alone at 124, 1,024,
             4,096, 6,144, 8,192, 12,288 and 16,383 lanes, at every group the
             same way; decompress at the 31,744 tracker points with the edge
             lanes added (also by CUDA graph), compress on its output,
             glv_records at 2^16 points with identity lanes (beside its
             plain chain in turns), and an empty kernel by CUDA graph beside
             the three (`launch_floor_ms`, the fixed cost of a launch); and the
             guard: the PyTorch ops on CUDA tensors of one
             `_glv_stream_packed` and one `batch_decompress` call, under a
             dispatch-mode counter, at most GUARD_MAX_OPS each.
             Launch counts are those of
             the main-path phases above (the eight MSM and vector phases,
             entry, the three Whisk phases with kernels, the decode and the
             two sharded phases): set to 0 just before each, read just after it
  group_ab   the groups the wrappers pick against one thread a lane, in
             turns: msm() at 2^16 (device span, wall), the vector ops'
             scalar_mul at both widths (device ms) and scale_points (wall),
             msm() through the GLV ladder at 4,096 and msm_ladder_segmented
             at 64 x 128 (device span, wall)
  trace_msm  one warm msm() at 2^16 under utils.profiling.device_trace
             (torch.profiler, a Chrome trace in a temporary directory): the
             kernels' summed time, the device's busy share of the traced
             window, launches and ms by name; then msm()'s device span with
             the GLV records on their kernel and on the plain chain, in turns

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit. `--rehearse-cpu` walks the same control flow at
a tiny size on the CPU with the plain versions, to find faults without a
card (the Whisk phases at ell = 4 and K = 4, with DEVICE_MIN and
DECOMPRESS_DEVICE_MIN lowered so the merged MSMs and the decode take the
tensor code; both sharded worlds over gloo, the four ranks' selection
lowered so their 32 points a rank take the sel path); it prints no result
and exits 2. `--product-variants` adds a phase
after kernel_times: the sources built once per entry of PRODUCT_VARIANTS
(the field arithmetic on carry chains, the default; the arithmetic before
it, cios64; by reference; inlined; each scan with the other's register
cap),
the compilers side by side, each build's ptxas figures, nvcc seconds and
machine instructions (and those of one fq_mul and one fq_sqr), and all
nine kernels (scan_sel also at split 1, point_op also at group 1, the GLV
ladders also at 8,192 lanes, ladder_w3 alone at both vector widths) timed
under every build of their source that compiled, at the shapes above,
three rounds in turns, bit-equal to the loaded build (the field kernels
of field_kernels.cu are not among them). `--ptxas` prints the
default build's ptxas figures (registers, stack, spills of every template
instantiation, by readable name) and machine instructions per kernel
without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from curdleproofs_tpu_torch import G1, Fr, msm
from curdleproofs_tpu_torch import protocol as P
from curdleproofs_tpu_torch import vectors
from curdleproofs_tpu_torch import curve as hcurve
from curdleproofs_tpu_torch.curve import msm_host
from curdleproofs_tpu_torch.fields import FQ_MOD, FR_MOD
from curdleproofs_tpu_torch.ops import compress as ocompress
from curdleproofs_tpu_torch.ops import cuda_g1
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import gather as ogather
from curdleproofs_tpu_torch.ops import glv as oglv
from curdleproofs_tpu_torch.ops import modarith as ma
from curdleproofs_tpu_torch.ops import msm as omsm
from curdleproofs_tpu_torch.ops import route as oroute
from curdleproofs_tpu_torch.ops import scan as oscan
from curdleproofs_tpu_torch.ops import stream_scan as ostream
from curdleproofs_tpu_torch.ops import vector as ovec
from curdleproofs_tpu_torch.ops.fieldspec import FQ_SPEC, from_reference, ints_to_limbs, to_reference
from curdleproofs_tpu_torch.parallel import distributed, make_mesh, msm_sharded, msm_sharded_ladder, msm_sharded_stream
from curdleproofs_tpu_torch.parallel.dryrun import dryrun_multichip, entry, points_and_scalars
from curdleproofs_tpu_torch.parallel.msm import _local_width
from curdleproofs_tpu_torch.utils import host_native
from curdleproofs_tpu_torch.utils.profiling import device_trace, metrics, trace_summary
from curdleproofs_tpu_torch.utils.rng import ProofRng

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
GATHER_CU = "curdleproofs_tpu_torch/csrc/gather.cu"
FIELD_CU = "curdleproofs_tpu_torch/csrc/field_kernels.cu"
# 32-bit multiplies of one Montgomery square over 12 words: the 78 distinct
# word products of a*a, then the reduction's m*p and m
MULS_PER_SQR = 12 * 13 // 2 + 12 * 12 + 12
# the tracker decode against the host C decoder at these widths
DECODE_SIZES = (1024, 4096, 8192, 31744)
# PyTorch ops on CUDA tensors that one call of `_glv_stream_packed` or of
# `batch_decompress` may run: uploads, allocations, views, the readback
# (the plain chains ran 699 and 383,902)
GUARD_MAX_OPS = 16


PHASE_SECONDS = {}
T_START = time.perf_counter()


def sqrt_chain_cost(max_window: int = 8) -> tuple:
    """(squares, products) of the cheapest sliding-window chain for the
    square-root exponent (p + 1) / 4 over windows of 1 to max_window bits,
    the odd powers it multiplies by counted: the least work of the root."""
    bits = bin((FQ_MOD + 1) // 4)[2:]
    best = None
    for k in range(1, max_window + 1):
        squares = products = 0
        i = bits.index("1")
        j = min(i + k, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        i = j  # the leading window is a table entry
        while i < len(bits):
            if bits[i] == "0":
                squares, i = squares + 1, i + 1
                continue
            j = min(i + k, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            squares, products, i = squares + j - i, products + 1, j
        if k > 1:  # rhs^2, then rhs^3, ..., rhs^(2^k - 1)
            squares, products = squares + 1, products + 2 ** (k - 1) - 1
        cost = (squares, products)
        if best is None or squares * MULS_PER_SQR + products * MULS_PER_MONT < (
                best[0] * MULS_PER_SQR + best[1] * MULS_PER_MONT):
            best = cost
    return best


def emit(obj) -> None:
    # one write a line: the ranks of sharded_ranks4 print beside each other
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


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


def graph_ms(fn, iters: int) -> float:
    """Device ms of one fn() call without the host's launch overhead: `iters`
    calls captured in one CUDA graph, replayed three times between CUDA
    events. For kernels shorter than the wrappers' Python (tens of us)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / (3 * iters)


def wall_ms(fn, dev) -> tuple:
    """(result, wall ms) of one fn() call ending in a synchronise."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same_points(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two (72, ...) Jacobian tensors hold the same points, lane for lane."""
    def host(t):
        t = t.reshape(72, -1)
        return og.jpoints_to_host(og.JPoints(t[:24], t[24:48], t[48:]))

    return host(a) == host(b)


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
    half of those have a negative k1); for ladder_w1 one more lane has the
    scalar r + 2, whose last step adds P to P (the complete add's doubling).
    Each kernel against its plain version on all three coordinates, at every
    thread group, and against the host's P * s."""
    edges = list(oglv.EDGE_SCALARS)
    ks = edges + [rand_scalar(rng) for _ in range(m - len(edges))]
    pts = list(bases[:m])
    pts[len(edges)] = G1.identity()
    pts[len(edges) + 2] = pts[len(edges) + 1]
    ks_w1 = list(ks)
    ks_w1[len(edges) + 3] = FR_MOD + 2
    ap = og.pack_points(pts, dev)
    sc = np.asarray(ints_to_limbs(ks, 16), dtype=np.uint32)
    calls, (s1, neg1, s2) = ladder_calls(ap, sc, dev)
    sc_d = from_reference(sc, dev)
    sc_w1 = from_reference(np.asarray(ints_to_limbs(ks_w1, 16), dtype=np.uint32), dev)
    calls["ladder_w1"] = (
        lambda: og.scalar_mul_w1(ap, sc_w1),
        lambda: og._scalar_mul_plain(ap, sc_w1, acc0=og._jzero(ap.x)),
    )
    want = {name: [p * Fr(k) for p, k in zip(pts, ks_w1 if name == "ladder_w1" else ks)] for name in calls}
    glv_args = (ap, from_reference(s1, dev), from_reference(neg1, dev), from_reference(s2, dev))
    by_group_calls = {  # name -> (call at thread group g, the group the wrapper picks)
        "ladder_w3": (lambda g: cuda_g1.scalar_mul(ap, sc_d, g), cuda_g1.ladder_group(m)),
        **{f"ladder_glv_w{w}": (lambda g, w=w: cuda_g1.scalar_mul_glv(*glv_args, w=w, group=g),
                                cuda_g1.ladder_glv_group(m, w)) for w in (3, 4)},
        "ladder_w1": (lambda g: cuda_g1.scalar_mul_w1(ap, sc_w1, g), cuda_g1.ladder_w1_group(m)),
    }
    out = {"m": m, "negative_k1_lanes": int(neg1.sum())}
    for name, (got_fn, want_fn) in calls.items():
        before = cuda_g1.launch_counts[name]
        got, ms_first = wall_ms(got_fn, dev)
        launched = cuda_g1.launch_counts[name] - before
        plain, plain_ms = wall_ms(want_fn, dev)
        out[name] = {
            "equal": max_abs_err(list(got), list(plain)) == 0,
            "host_check": og.jpoints_to_host(got) == want[name],
            "launched": launched,
            "ms": cuda_ms(got_fn, 3) if dev.type == "cuda" else ms_first,
            "plain_ms": plain_ms,
        }
        if name in by_group_calls and dev.type == "cuda":
            # every group width, not only the one the wrapper picks
            fn, picked = by_group_calls[name]
            by_group = {str(g): max_abs_err(list(fn(g)), list(plain)) == 0 for g in cuda_g1.GROUPS}
            out[name].update(equal=out[name]["equal"] and all(by_group.values()), equal_by_group=by_group,
                             group=picked)
    return out


def phase_kernels(bases, dev, rng, m_ladder, route_shape):
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
            ("jadd", lambda g=None: cuda_g1.jadd(pj, qj, g), lambda: og._jadd_formulas(pj, qj)),
            ("jdbl", lambda g=None: cuda_g1.jdbl(pj, g), lambda: og._jdbl_formulas(pj)),
            ("jmadd", lambda g=None: cuda_g1.jmadd(pj, aq, g), lambda: og._jmadd_formulas(pj, aq)),
        ):
            w = want()
            by_group = {str(g): max_abs_err(list(got(g)), list(w)) == 0 for g in cuda_g1.GROUPS}
            point[name] = {
                "equal": all(by_group.values()),
                "equal_by_group": by_group,
                "group": cuda_g1.point_group(m, name),
                "ms": cuda_ms(got, 5),
                "plain_ms": wall_ms(want, dev)[1],
            }
    out["point_op"] = point
    # point_strided: the prefix scan's schedule over 3 x 256 of the q records
    # (a doubling at lanes 2, 3, identities at 5 and 7)
    strided = strided_edge_check(aq) if dev.type == "cuda" else {}
    out["point_strided"] = strided

    # gather: random tables, indices from -3 to N + 2, ragged M, per-window
    # and shared tables, point records and Jacobian triples, in both layouts
    # (the wrapper's pick and the other one), each one launch
    gather_cases = {}
    for name, (R, Wt, W, N, M) in {
        "records49": (49, 2, 2, 200, 300), "shared49": (49, 1, 3, 200, 300), "triples72": (72, 3, 3, 5000, 333),
    }.items():
        table = torch.from_numpy(rng.integers(0, 1 << 16, (R, Wt, N)).astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(-3, N + 3, (W, M)).astype(np.int32)).to(dev)
        want = ogather.gather_u32_ref(table.expand(R, W, N), idx)
        errs = {}
        for records in (True, False):
            src = ogather.record_major(table) if records else table
            before = cuda_g1.launch_counts["gather_u32"]
            got = ogather.gather_layout(src, idx, R, records=records)
            errs["records" if records else "rows"] = {
                "max_abs_err": max_abs_err(got, want),
                "launched": cuda_g1.launch_counts["gather_u32"] - before,
            }
        before = cuda_g1.launch_counts["gather_u32"]
        got = ogather.gather_u32_shared(table[:, 0], idx) if Wt == 1 else ogather.gather_u32(table, idx)
        errs["wrapper"] = {
            "max_abs_err": max_abs_err(got, want),
            "launched": cuda_g1.launch_counts["gather_u32"] - before,
        }
        gather_cases[name] = errs
    safe = idx.clamp(0, N - 1).to(torch.int64).unsqueeze(0).expand(R, -1, -1)
    out["gather_u32"] = {
        "cases": gather_cases,
        "equal": all(v["max_abs_err"] == 0 for c in gather_cases.values() for v in c.values()),
        "ms": cuda_ms(lambda: ogather.gather_u32(table, idx), 5) if dev.type == "cuda" else None,
        "plain_ms": wall_ms(lambda: ogather.gather_u32_ref(table, idx), dev)[1],
        "library_ms": wall_ms(lambda: torch.gather(table, 2, safe), dev)[1],
    }
    if dev.type == "cuda" and any(v["launched"] != 1 for c in gather_cases.values() for v in c.values()):
        fail("gather_u32: the wrapper did not launch its kernel once per call")

    # rowwise_gather: one group with a ragged M and indices from -3 to K + 2,
    # then the three stage shapes of the routed gather as the routed path
    # launches them (r, c of the main width, a chunk of ROUTE_WINDOW_BATCH
    # windows) and with all W windows in one launch, random 16-bit tables
    rr, rc, Wr = route_shape
    Wc = min(Wr, omsm.ROUTE_WINDOW_BATCH)
    row_shapes = {
        "edge": (1, 49, 300, 1000),
        "stage1": (rr, 49, rc, Wc * rc),
        "stage2": (Wc * rc, 49, rr, rr),
        "stage3": (Wc * rr, 49, rc, rc),
        "stage1_all_windows": (rr, 49, rc, Wr * rc),
        "stage2_all_windows": (Wr * rc, 49, rr, rr),
        "stage3_all_windows": (Wr * rr, 49, rc, rc),
    }
    rowwise = {}
    for name, (G, R, K, M) in row_shapes.items():
        table = torch.from_numpy(rng.integers(0, 1 << 16, (G, R, K), dtype=np.int32)).to(dev)
        lo, hi = (-3, K + 3) if name == "edge" else (0, K)
        idx = torch.from_numpy(rng.integers(lo, hi, (G, M), dtype=np.int32)).to(dev)
        before = cuda_g1.launch_counts["rowwise_gather"]
        got = ogather.rowwise_gather(table, idx)
        launched = cuda_g1.launch_counts["rowwise_gather"] - before
        rowwise[name] = {
            "shape": [G, R, K, M],
            "max_abs_err": max_abs_err(got, ogather.rowwise_gather_ref(table, idx)),
            "launched": launched,
        }
        del table, idx, got
    # routed_gather against packed[:, src], tables from the native solver
    n_r = rr * rc
    packed_r = torch.from_numpy(rng.integers(0, 1 << 16, (49, n_r), dtype=np.int32)).to(dev)
    src = np.stack([rng.permutation(n_r) for _ in range(2)]).astype(np.int32)
    tables = [from_reference(t, dev) for t in oroute.decompose(rr, rc, src)]
    got = ogather.routed_gather(packed_r, *tables)
    want = torch.stack([packed_r[:, torch.from_numpy(src[w]).to(dev).long()] for w in range(2)], dim=1)
    rowwise["routed_gather"] = {"r": rr, "c": rc, "W": 2, "max_abs_err": max_abs_err(got, want)}
    out["rowwise_gather"] = rowwise
    del packed_r, tables, got, want

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
    # at split 1 and at the default split: bit-equal to the plain version at
    # the same split; window 1 (no collision) equal as points to split 1
    k_main = ostream.split_steps(T)
    by_split = {}
    for name, k in (("scan_sel_split1", 1), ("scan_sel", k_main)):
        got = ostream.scan_records_sel(rec, sel_d, W, T, L, S, split=k)
        want = ostream.scan_records_sel_ref(rec, sel_d, W, T, L, S, split=k)
        flags = [int(v) for v in got[2].cpu()]
        by_split[k] = got
        out[name] = {
            "split": k,
            "equal": max_abs_err(list(got), list(want)) == 0,
            "flags": flags,
            "collision_flagged": flags == [1, 0],
            "ms": cuda_ms(lambda k=k: ostream.scan_records_sel(rec, sel_d, W, T, L, S, split=k), 3)
            if dev.type == "cuda"
            else None,
            "plain_ms": wall_ms(lambda k=k: ostream.scan_records_sel_ref(rec, sel_d, W, T, L, S, split=k), dev)[1],
        }
    out["scan_sel"]["window1_points_equal_split1"] = all(
        same_points(a[:, 1], b[:, 1]) for a, b in zip(by_split[k_main][:2], by_split[1][:2])
    )
    # the complete scan on the same records with lane 9 of window 1 one point
    # at every step (the complete add doubles in phases A, B and C), at split
    # 1 and at the default split: bit-equal to the plain version at the same
    # split, every prefix and total the same point at both
    rec_f = rec.reshape(49, W, T, L).clone()
    rec_f[:, 1, :, 9] = rec_f[:, 1, :1, 9]
    rec_f = rec_f.reshape(49, W * T * L).contiguous()
    by_split = {}
    for name, k in (("scan_full_split1", 1), ("scan_full", k_main)):
        got = ostream.scan_records(rec_f, W, T, L, split=k)
        want = ostream.scan_records_ref(rec_f, W, T, L, split=k)
        by_split[k] = got
        out[name] = {
            "split": k,
            "equal": max_abs_err(list(got), list(want)) == 0,
            "ms": cuda_ms(lambda k=k: ostream.scan_records(rec_f, W, T, L, split=k), 3)
            if dev.type == "cuda"
            else None,
            "plain_ms": wall_ms(lambda k=k: ostream.scan_records_ref(rec_f, W, T, L, split=k), dev)[1],
        }
    out["scan_full"]["points_equal_split1"] = all(
        same_points(a, b) for a, b in zip(by_split[k_main], by_split[1])
    )
    out["ladders"] = lad = ladder_edge_checks(bases, dev, rng, m_ladder)
    out["field"] = fld = field_edge_checks(bases, dev)
    emit(out)
    bad = [k for k in ("gather_u32", "scan_sel", "scan_sel_split1", "scan_full", "scan_full_split1")
           if not out[k]["equal"]]
    bad += [f"point_op[{k}]" for k, v in point.items() if not v["equal"]]
    if strided and not strided["equal"]:
        bad.append("point_strided")
    for k, v in lad.items():
        if isinstance(v, dict):
            if not (v["equal"] and v["host_check"]):
                bad.append(k)
            if dev.type == "cuda" and v["launched"] != 1:
                fail(f"{k}: the wrapper launched its kernel {v['launched']} times, not once")
    for k in ("decompress", "compress", "glv_records"):
        if fld[k]["max_abs_err"] != 0:
            bad.append(k)
        if dev.type == "cuda" and fld[k]["launched"] != 1:
            fail(f"{k}: the wrapper launched its kernel {fld[k]['launched']} times, not once")
    if not 0 < lad["negative_k1_lanes"] < lad["m"]:
        bad.append("ladder lanes lack a negative or a positive k1")
    if not (out["scan_sel"]["collision_flagged"] and out["scan_sel_split1"]["collision_flagged"]):
        bad.append("scan_sel flags")
    if not out["scan_sel"]["window1_points_equal_split1"]:
        bad.append("scan_sel split vs split 1 as points")
    if not out["scan_full"]["points_equal_split1"]:
        bad.append("scan_full split vs split 1 as points")
    bad += [f"rowwise_gather[{k}]" for k, v in rowwise.items() if v["max_abs_err"] != 0]
    if dev.type == "cuda" and any(v.get("launched", 1) != 1 for v in rowwise.values()):
        fail("rowwise_gather: the wrapper did not launch its kernel once per call")
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")


# ---------------------------------------------------------------------------
# phases: the MSM through its entry point
# ---------------------------------------------------------------------------


def _counts():
    return dict(cuda_g1.launch_counts)


def _delta(before):
    return {k: cuda_g1.launch_counts[k] - before[k] for k in before}


def _span_s(rep, name, reps):
    """Mean seconds per repetition of one span (0 where it never ran)."""
    return rep[name]["total_time_s"] / reps if name in rep else 0.0


def _prep_ran(rep):
    """Which host prep the stream MSMs of a metrics report ran."""
    return {k: rep[f"msm.stream.host_prep.{k}"]["calls"] for k in ("native", "numpy")
            if f"msm.stream.host_prep.{k}" in rep}


def phase_entry(dev):
    """`parallel.dryrun.entry()`, the single-device entry: its forward (one
    Pippenger window-partials step, n = 1024, c = 8, the JAX entry's inputs)
    run on the card in the counted run; the window total is the sum of the
    points, and the MSM recombined from the total and the 32 bucket sums
    equals the host MSM. Then three warm walls."""
    cuda_g1.reset_launch_counts()
    forward, (packed, digits) = entry(device=dev)
    (total, bsums), first_ms = wall_ms(lambda: forward(packed, digits), dev)
    launches = _counts()
    n, c, W = packed.shape[1], 8, digits.shape[0]
    pts, scs = points_and_scalars(n)
    t_host = og.jpoints_to_host(og.JPoints(total.x[:, None], total.y[:, None], total.z[:, None]))[0]
    b_host = og.jpoints_to_host(bsums)
    shapes = [tuple(total.x.shape), tuple(bsums.x.shape)] == [(24,), (24, W)]
    total_ok = t_host == G1() * Fr(n * (n + 1) // 2)  # P_i = (i + 1) G
    msm_ok = omsm._combine_windows_host(t_host, b_host, c, W) == msm_host(pts, scs)
    walls = [wall_ms(lambda: forward(packed, digits), dev)[1] for _ in range(REPS)]
    emit({"phase": "entry", "n": n, "c": c, "windows": W, "shapes_ok": shapes, "total_is_the_sum": total_ok,
          "msm_equal_host": msm_ok, "first_ms": first_ms, "wall_ms": _wall_stats(walls), "launches": launches})
    if not (shapes and total_ok and msm_ok):
        fail(f"entry: shapes {shapes}, total {total_ok}, MSM {msm_ok}")
    if dev.type == "cuda":
        missing = [k for k in ("gather_u32", "point_strided", "point_op") if not launches[k]]
        if missing:
            fail(f"entry: {missing} never launched")
    return launches


def phase_host_native(scalars, dev):
    """The native streaming-MSM host prep against the numpy chain on the
    scalars of the main path: every array equal, both times."""
    n = len(scalars)
    c = omsm.pick_window(n)
    L = ostream.pick_lanes(2 * n)
    T = 2 * n // L
    sc = np.asarray(ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32)
    host_native.msm_prep_batch(sc[:, :256], c, min(L, 512), omsm.SEL_SLOT_OPTIONS)  # warm-up
    t0 = time.perf_counter()
    neg, ocm, bidx, lidx, sel, bpos, S = host_native.msm_prep_batch(sc, c, L, omsm.SEL_SLOT_OPTIONS)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s1, neg_r, s2 = oglv.decompose_numpy(sc.astype(np.uint64))
    t_glv = time.perf_counter() - t0
    digits = omsm.host_digits(np.concatenate([s1, s2], axis=1).astype(np.uint32), c, bits=130)
    ocm_r, bidx_r, lidx_r, e = omsm.stream_host_prep(digits, c, L)
    for S_r in omsm.SEL_SLOT_OPTIONS:
        sel_r, bpos_r = omsm._build_sel(e, T, S_r)
        if sel_r is not None:
            break
    else:
        S_r = 0
    numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g1_, gn, g2 = oglv.decompose(sc.astype(np.uint64))
    glv_native_s = time.perf_counter() - t0
    equal = {
        "neg1": np.array_equal(neg, neg_r), "order_cm": np.array_equal(ocm, ocm_r),
        "bidx": np.array_equal(bidx, bidx_r), "lidx": np.array_equal(lidx, lidx_r),
        "S": S == S_r, "sel": S == 0 or np.array_equal(sel, sel_r),
        "bpos": S == 0 or np.array_equal(bpos, bpos_r),
        "glv_decompose": all(np.array_equal(a, b) for a, b in zip((g1_, gn, g2), (s1, neg_r, s2))),
    }
    emit(
        {
            "phase": "host_native", "n": n, "c": c, "L": L, "S": S,
            "build_s": host_native.build_seconds, "openmp_threads": host_native.openmp_threads(),
            "equal": equal, "native_prep_s": native_s, "numpy_chain_s": numpy_s,
            "glv_decompose_native_s": glv_native_s, "glv_decompose_numpy_s": t_glv,
        }
    )
    if not all(equal.values()):
        fail(f"the native host prep disagrees with the numpy chain: {equal}")


def phase_msm_main(bases, scalars, coef, dev, point_widths):
    """msm() at n = 2^16. Records in point_widths["msm"] the (body, m) of
    every point_op launch of its counted call, for kernel_times' sweep."""
    cuda_g1.reset_launch_counts()
    n = len(bases)
    before = _counts()
    c = omsm.pick_window(n)
    want = dlog_expect(coef, scalars)
    got, point_widths["msm"] = record_point_launches(lambda: msm(bases, scalars, device=dev), dev)  # warm-up, checked
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
    split["pack_points"] = mean_s("msm.stream.pack")
    split["host_prep_native"] = _span_s(rep, "msm.stream.host_prep.native", REPS)
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
            "point_op_widths": {f"{b} {m}": c for (b, m), c in sorted(point_widths["msm"].items())},
            "fast_path": launches_one["scan_full"] == 0,
            "wall_s": {"median": float(np.median(walls)), "min": min(walls), "max": max(walls)},
            "split_s": split,
            "host_prep_ran": _prep_ran(rep),
            "reps": REPS,
            "c12_W11": {"dlog_check": c12_ok, "wall_s": c12_wall},
        }
    )
    if not (dlog_ok and sub_ok and c12_ok):
        fail("msm_2e16 result is wrong")
    if _prep_ran(rep) != {"native": REPS}:
        fail(f"msm_2e16 did not run the native host prep: {_prep_ran(rep)}")
    for k in ("scan_sel", "gather_u32", "point_op", "glv_records"):
        if dev.type == "cuda" and launches_one[k] == 0:
            fail(f"msm_2e16 never launched {k}")
    if dev.type == "cuda" and sum(point_widths["msm"].values()) != launches_one["point_op"]:
        fail(f"msm_2e16: point_op widths recorded {point_widths['msm']}, launches counted {launches_one['point_op']}")
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
    want = dlog_expect(coef, scalars)
    t0 = time.perf_counter()
    ok = msm(bases, scalars, device=dev) == want
    wall = time.perf_counter() - t0
    launches = _delta(before)
    emit(
        {
            "phase": "msm_split",
            "n": len(bases),
            "slices": -(-len(bases) // omsm.STREAM_SPLIT),
            "dlog_check": ok,
            "wall_s": wall,
            "launches": launches,
        }
    )
    if not ok:
        fail("msm_split result is wrong")
    return _counts()


def phase_msm_routed(bases, scalars, coef, dev):
    """msm_pippenger_stream(routed=True) at full width, beside the direct
    gather on the same packed inputs, in turns."""
    cuda_g1.reset_launch_counts()
    n = len(bases)
    c = omsm.pick_window(n)
    W = -(-130 // c)
    want = dlog_expect(coef, scalars)
    pts = og.pack_points(list(bases), dev)
    sc = np.asarray(ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32)
    sub = sc.copy()
    sub[:, 128:] = 0
    sub_want = msm_host(list(bases[:128]), list(scalars[:128]))

    def run(routed, s=sc):
        return wall_ms(lambda: omsm.msm_pippenger_stream(pts, s, routed=routed), dev)

    before = _counts()
    ok = {True: run(True)[0] == want, False: True}  # warm-up, checked
    launches_routed = _delta(before)
    before = _counts()
    ok[False] = run(False)[0] == want
    launches_direct = _delta(before)
    sub_ok = run(True, sub)[0] == sub_want
    walls = {True: [], False: []}
    spans = {True: {}, False: {}}  # mode -> span -> [seconds, calls], summed over its runs
    for routed in (True, False, False, True, True, False)[: 2 * REPS]:
        metrics().reset()
        got, ms = run(routed)
        walls[routed].append(ms / 1e3)
        ok[routed] = ok[routed] and got == want
        for name, v in metrics().report().items():
            acc = spans[routed].setdefault(name, [0.0, 0])
            acc[0] += v["total_time_s"]
            acc[1] += v["calls"]
    k = len(walls[True])

    def per_msm(mode, name):
        return spans[mode].get(name, [0.0, 0])[0] / len(walls[mode])

    split_names = ("host_prep", "host_prep.native", "route_wait", "device", "combine")
    solve_s, solve_calls = spans[True].get("msm.stream.route_solve", [0.0, 0])
    rr, rc = oroute.pick_rc(2 * omsm._pow2_at_least(n, 128), omsm.ROUTE_MIN_FACTOR)
    emit(
        {
            "phase": "msm_routed",
            "n": n, "c": c, "W": W, "r": rr, "c_route": rc,
            "window_batch": omsm.ROUTE_WINDOW_BATCH,
            "chunks": -(-W // omsm.ROUTE_WINDOW_BATCH),
            "dlog_check": ok[True],
            "first128_check": sub_ok,
            "direct_dlog_check": ok[False],
            "launches_per_msm": launches_routed,
            "launches_per_direct_msm": launches_direct,
            "wall_s_packed_inputs": {"routed": _wall_stats(walls[True]), "direct": _wall_stats(walls[False])},
            "routed_split_s": {n_: per_msm(True, f"msm.stream.{n_}") for n_ in split_names},
            "direct_split_s": {n_: per_msm(False, f"msm.stream.{n_}") for n_ in split_names},
            "route_solve_s_per_window": solve_s / max(solve_calls, 1),
            "route_solve_windows_per_msm": solve_calls / k,
            "host_prep_ran": {m: c_[1] for m in ("native", "numpy")
                              for c_ in [spans[True].get(f"msm.stream.host_prep.{m}")] if c_},
            "route_pool_workers": omsm._route_pool()._max_workers,
            "reps": k,
        }
    )
    if not (ok[True] and ok[False] and sub_ok):
        fail("msm_routed result is wrong")
    if dev.type == "cuda":
        chunks = -(-W // omsm.ROUTE_WINDOW_BATCH)
        if launches_routed["rowwise_gather"] != 3 * chunks:
            fail(f"routed msm launched rowwise_gather {launches_routed['rowwise_gather']} times, not {3 * chunks}")
        if launches_direct["rowwise_gather"] != 0:
            fail("the direct-gather msm launched rowwise_gather")
        if launches_routed["scan_sel"] != chunks or launches_routed["scan_full"]:
            fail("routed msm did not take the sel scan once per chunk")
    return _counts()


def phase_msm_sort(bases, scalars, coef, dev):
    """The two sort-based engines through msm()."""
    cuda_g1.reset_launch_counts()
    want = dlog_expect(coef, scalars)
    out = {"phase": "msm_sort", "n": len(bases)}
    for method in ("pippenger", "hostsort"):
        before = _counts()
        t0 = time.perf_counter()
        ok = msm(bases, scalars, method=method, device=dev) == want
        first = time.perf_counter() - t0
        launches = {k: v for k, v in _delta(before).items() if v}
        t0 = time.perf_counter()
        ok = msm(bases, scalars, method=method, device=dev) == want and ok
        out[method] = {"dlog_check": ok, "first_wall_s": first, "wall_s": time.perf_counter() - t0,
                       "launches_per_msm": launches}
    emit(out)
    for method in ("pippenger", "hostsort"):
        if not out[method]["dlog_check"]:
            fail(f"msm(method={method!r}) result is wrong")
        used = out[method]["launches_per_msm"]
        if dev.type == "cuda" and not (used.get("point_strided") and used.get("point_op") and used.get("gather_u32")):
            fail(f"msm(method={method!r}) did not go through point_strided, point_op and gather_u32")
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


def phase_vector_ops(bases, scalars, coef, dev, n_small, n_big, n_sample, rng, point_widths):
    """The vector ops at the width of one shuffle and at the lockstep
    prover's width. Operands: a = bases[:n], b = bases[n:2n]. Records in
    point_widths[f"scale_points_{n}"] the (body, m) of every point_op launch
    of scale_points, for kernel_times' sweep."""
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
            (got, ms), widths = record_point_launches(lambda f=fn: wall_ms(f, dev), dev)
            launches = {k: v for k, v in _delta(before).items() if v}
            if name == "scale_points":
                point_widths[f"scale_points_{n}"] = widths
                if dev.type == "cuda" and not sum(widths.values()) == launches.get("point_op") == 6:
                    fail(f"scale_points[{n}]: point_op widths recorded {widths}, launches counted {launches}, "
                         "the ladder's table takes 6")
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
# phases: the Whisk protocol through its entry points
# ---------------------------------------------------------------------------


def _trackers(rng, ell):
    """ell trackers (r*G, k*r*G) from a seeded ProofRng, on the host backend."""
    rs = [rng.random_scalar() for _ in range(ell)]
    ks = [rng.random_scalar() for _ in range(ell)]
    r_G = hcurve.mul_host_batch([G1()] * ell, rs)
    blob_r = hcurve.compress_host_batch(r_G)
    blob_k = hcurve.compress_host_batch(hcurve.mul_host_batch(r_G, ks))
    return [P.WhiskTracker(blob_r[48 * i : 48 * i + 48], blob_k[48 * i : 48 * i + 48]) for i in range(ell)]


def _spans(rep, names):
    return {k: rep[k]["total_time_s"] for k in names if k in rep}


def _post_bytes(results):
    return [(b"".join(t.r_G + t.k_r_G for t in post), proof) for post, proof in results]


def phase_whisk_single(crs, pre, dev, seed):
    """One shuffle proof, its verification and a tracker proof through the
    Whisk API at the CRS's ell, REPS times each: at n = ell + 4 < DEVICE_MIN
    every vector operation runs on the host backend, so no kernel launches.
    The proof bytes equal those of the pure-Python curve and transcript
    (the oracle) under the same seed."""
    cuda_g1.reset_launch_counts()
    metrics().reset()
    walls = {"prove": [], "verify": [], "tracker_prove": [], "tracker_verify": []}
    ok = True
    for _ in range(REPS):
        (post, proof), ms = wall_ms(lambda: P.GenerateWhiskShuffleProof(crs, pre, ProofRng(seed), device=dev), dev)
        walls["prove"].append(ms / 1e3)
        good, ms = wall_ms(lambda: P.IsValidWhiskShuffleProof(crs, pre, post, proof, device=dev), dev)
        walls["verify"].append(ms / 1e3)
        ok = ok and good
        k = ProofRng(seed + 1).random_scalar()
        r_G = G1.from_compressed_bytes_unchecked(post[0].r_G)
        tracker = P.WhiskTracker(post[0].r_G, (r_G * k).to_compressed_bytes())
        k_commit = (G1() * k).to_compressed_bytes()
        tproof, ms = wall_ms(lambda: P.GenerateWhiskTrackerProof(tracker, k, ProofRng(seed + 2), device=dev), dev)
        walls["tracker_prove"].append(ms / 1e3)
        good, ms = wall_ms(lambda: P.IsValidWhiskOpeningProof(tracker, k_commit, tproof, device=dev), dev)
        walls["tracker_verify"].append(ms / 1e3)
        ok = ok and good
    launches = _counts()
    touched = sorted(k for k in metrics().report() if k.startswith(("msm.", "vectors.")))
    bad = bytearray(proof)
    bad[-40] ^= 1
    rejects = not P.IsValidWhiskShuffleProof(crs, pre, post, bytes(bad), device=dev)
    # the oracle: pure-Python curve and transcript, the same seed
    t0 = time.perf_counter()
    os.environ["CURDLEPROOFS_TRANSCRIPT_NATIVE"] = "0"
    try:
        with hcurve.oracle():
            opost, oproof = P.GenerateWhiskShuffleProof(crs, pre, ProofRng(seed), device=dev)
    finally:
        del os.environ["CURDLEPROOFS_TRANSCRIPT_NATIVE"]
    oracle_s = time.perf_counter() - t0
    oracle_ok = oproof == proof and _post_bytes([(opost, oproof)]) == _post_bytes([(post, proof)])
    emit(
        {
            "phase": "whisk_single", "ell": crs.ell, "n": crs.ell + crs.n_blinders, "proof_bytes": len(proof),
            "valid": ok, "flipped_byte_rejected": rejects, "oracle_bytes_equal": oracle_ok,
            "oracle_prove_s": oracle_s, "wall_s": {k: _wall_stats(v) for k, v in walls.items()},
            "card_touched": bool(sum(launches.values()) or touched), "launches": launches,
        }
    )
    if not (ok and rejects and oracle_ok):
        fail(f"whisk_single: valid {ok}, flipped byte rejected {rejects}, oracle bytes equal {oracle_ok}")
    if sum(launches.values()) or touched:
        fail(f"whisk_single reached the card at n = {crs.ell + 4}: launches {launches}, spans {touched}")
    return launches


def phase_whisk_batch_verify(crs, pres, dev, seed, proofs):
    """K shuffle proofs made by the thread prover, then ONE batched
    verification: the tracker decode of 4*ell*K points (ops.compress on the
    card) and one merged MSM (the streaming Pippenger from STREAM_MIN bases).
    True, and False with one proof byte flipped. Stores the proofs in
    `proofs` for the lockstep phase."""
    (results, prove_ms) = wall_ms(lambda: P.GenerateWhiskShuffleProofs(crs, pres, ProofRng(seed), device=dev), dev)
    proofs["thread"], proofs["thread_s"] = results, prove_ms / 1e3
    instances = [(pre, post, proof) for pre, (post, proof) in zip(pres, results)]
    cuda_g1.reset_launch_counts()
    metrics().reset()
    ok, ms = wall_ms(lambda: P.AreValidWhiskShuffleProofs(crs, instances, device=dev), dev)
    launches = _counts()
    rep = metrics().report()
    engine = next((m for m in ("stream", "ladder", "hostsort", "pippenger") if f"msm.{m}" in rep), "host")
    width = rep[f"msm.{engine}"]["total_items"] if engine != "host" else 0
    pre0, post0, pb0 = instances[0]
    bad = bytearray(pb0)
    bad[60] ^= 1
    rejected, bad_ms = wall_ms(
        lambda: not P.AreValidWhiskShuffleProofs(crs, [(pre0, post0, bytes(bad))] + instances[1:], device=dev), dev
    )
    decode_spans = ("whisk.batch.decode", "decompress.parse", "decompress.upload", "decompress.device",
                    "decompress.unpack")
    spans = _spans(rep, decode_spans + ("whisk.batch.replay", "msm_accumulator.dedup", "vectors.pack",
                                        f"msm.{engine}", f"msm.{engine}.host_prep", f"msm.{engine}.device",
                                        f"msm.{engine}.combine"))
    # once more with the decode on the plain chain (the port before its
    # kernel, on the same device): the decode before and after in one run
    metrics().reset()
    kernel_path = ocompress._decompress_device
    ocompress._decompress_device = ocompress._decompress_plain
    try:
        ok_plain, plain_ms = wall_ms(lambda: P.AreValidWhiskShuffleProofs(crs, instances, device=dev), dev)
    finally:
        ocompress._decompress_device = kernel_path
    plain_chain = {"valid": ok_plain, "wall_s": plain_ms / 1e3, "spans_s": _spans(metrics().report(), decode_spans)}
    emit(
        {
            "phase": "whisk_batch_verify", "K": len(pres), "ell": crs.ell, "thread_prove_s": prove_ms / 1e3,
            "valid": ok, "flipped_byte_rejected": rejected, "wall_s": ms / 1e3, "wall_s_flipped": bad_ms / 1e3,
            "merged_msm": {"engine": engine, "bases": width, "msm_calls": rep.get(f"msm.{engine}", {}).get("calls")},
            "decoded_points": rep.get("whisk.batch.decode", {}).get("total_items", 0),
            "spans_s": spans, "launches": launches, "decode_on_the_plain_chain": plain_chain,
        }
    )
    if not (ok and rejected and ok_plain):
        fail(f"whisk_batch_verify: valid {ok} (plain chain {ok_plain}), flipped byte rejected {rejected}")
    if dev.type == "cuda":
        missing = [k for k in ("scan_sel", "gather_u32", "point_op", "decompress") if not launches[k]]
        if missing or engine != "stream":
            fail(f"whisk_batch_verify: the merged MSM ran on {engine}, {missing} never launched")
    return launches


def phase_decompress(pres, proofs, dev):
    """The batched verifier's tracker batch (pre and post columns of every
    instance, 4*ell*K points) through the port's entry points: decoded on
    the card (ops.compress: `decompress` launches) and encoded back
    (`batch_compress`: one `compress` launch), the bytes equal to the input,
    the points equal to the host C decoder's (csrc/g1_host.c, across host
    threads). Then, outside the counted run, the decode's parts (the
    host parse, the upload, the kernel by CUDA events, the readback and
    unpack_points), and the kernel path against the host C decoder at
    DECODE_SIZES points, three walls each in turns (medians), and where
    they cross."""
    blob = b"".join(
        b"".join(t.r_G for t in pre) + b"".join(t.k_r_G for t in pre)
        + b"".join(t.r_G for t in post) + b"".join(t.k_r_G for t in post)
        for pre, (post, _) in zip(pres, proofs["thread"])
    )
    encs = [blob[48 * i : 48 * i + 48] for i in range(len(blob) // 48)]
    cuda_g1.reset_launch_counts()
    metrics().reset()
    dev_pts, dev_ms = wall_ms(lambda: ocompress.batch_decompress_to_host(encs, dev), dev)
    rep = metrics().report()
    ap, _ = ocompress.batch_decompress(encs, dev)
    round_trip = ocompress.batch_compress(ap) == encs
    launches = _counts()

    def host_decode(data):
        route = hcurve.DECOMPRESS_DEVICE_MIN
        hcurve.DECOMPRESS_DEVICE_MIN = len(data) // 48 + 1  # the host backend
        try:
            return hcurve.decompress_host_batch(data)
        finally:
            hcurve.DECOMPRESS_DEVICE_MIN = route

    host_pts, host_ms = wall_ms(lambda: host_decode(blob), dev)
    equal = dev_pts == host_pts
    x, signs, _ = ocompress.parse_encodings(encs)
    x_d, s_d = from_reference(x, dev), from_reference(signs, dev)
    kernel_ms = cuda_ms(lambda: ocompress._decompress_device(x_d, s_d), 5) if dev.type == "cuda" else None
    sizes = [k for k in DECODE_SIZES if k <= len(encs)] or [len(encs)]
    crossing = {}
    for k in sizes:
        walls = in_turns({"kernel_path": lambda k=k: ocompress.batch_decompress_to_host(encs[:k], dev),
                          "host_c": lambda k=k: host_decode(blob[: 48 * k])},
                         REPS, lambda fn: wall_ms(fn, dev)[1] / 1e3)
        crossing[str(k)] = {key: float(np.median(v)) for key, v in walls.items()}
        crossing[str(k)]["kernel_path_wins"] = crossing[str(k)]["kernel_path"] < crossing[str(k)]["host_c"]
    emit(
        {
            "phase": "decompress", "points": len(encs), "equal": equal, "round_trip_bytes_equal": round_trip,
            "device_s": dev_ms / 1e3, "host_c_s": host_ms / 1e3, "host_threads": min(8, os.cpu_count() or 1),
            "spans_s": _spans(rep, ("decompress.parse", "decompress.upload", "decompress.device",
                                    "decompress.unpack")),
            "kernel_ms": kernel_ms, "launches": launches, "kernel_path_vs_host_c_s": crossing,
            "kernel_path_wins_from": next(
                (k for k in sizes if all(crossing[str(j)]["kernel_path_wins"] for j in sizes if j >= k)), None),
        }
    )
    if not (equal and round_trip):
        fail(f"decompress: the card's decode equals the host C decoder's {equal}, round trip {round_trip}")
    if dev.type == "cuda" and not (launches["decompress"] and launches["compress"]):
        fail(f"decompress: the decode or the encode never launched its kernel: {launches}")
    return launches, encs


def field_edge_lanes():
    """x limbs and sign flags of the decode's edge lanes: x = 0 (the lanes
    that carry infinity) with both signs, three x with no root, x = p - 1
    with both signs, and a point with both signs."""
    nonres, x = [], 1
    while len(nonres) < 3:
        if hcurve.fq_sqrt((x**3 + 4) % FQ_MOD) is None:
            nonres.append(x)
        x += 1
    g = G1() * Fr(7)
    xs = [0, 0] + nonres + [FQ_MOD - 1, FQ_MOD - 1, g.x, g.x]
    signs = np.array([False, True, False, True, False, False, True, False, True], dtype=bool)
    return ints_to_limbs(xs, 24), signs


def with_identity_lanes(ap, lanes):
    """Affine points with the given lanes set to the identity (zero
    coordinates, inf set), as pack_points writes it."""
    x, y, inf = ap.x.clone(), ap.y.clone(), ap.inf.clone()
    x[:, lanes] = 0
    y[:, lanes] = 0
    inf[lanes] = True
    return og.APoints(x, y, inf)


def field_edge_checks(bases, dev, m: int = 64) -> dict:
    """The three field kernels at m lanes against their plain versions:
    decompress on the edge lanes and m curve points of both signs, compress
    on its output, glv_records on m points with identity lanes and mixed
    neg1; each launched once."""
    pts = list(bases[:m])
    x_e, s_e = field_edge_lanes()
    x = np.concatenate([ints_to_limbs([p.x for p in pts], 24), x_e], axis=1)
    signs = np.concatenate([np.arange(m) % 3 == 0, s_e])
    x_d, s_d = from_reference(x, dev), from_reference(signs, dev)
    # lane 1 is both the identity and negated: fq_neg(0) must store 0
    ap = with_identity_lanes(og.pack_points(pts, dev), [0, 1, m // 2])
    neg1 = from_reference(np.arange(m) % 2 == 1, dev)
    before = _counts()
    got = ocompress._decompress_device(x_d, s_d)
    want = ocompress._decompress_plain(x_d, s_d)
    dec = og.APoints(got[0], got[1], torch.zeros(x.shape[1], dtype=torch.bool, device=dev))
    got_c = ocompress._compress_device(dec)
    got_r = omsm._glv_stream_packed(ap.x, ap.y, ap.inf, neg1)
    launched = _delta(before)
    out = {
        "decompress": max_abs_err(list(got), list(want)),
        "compress": max_abs_err(list(got_c), list(ocompress._compress_plain(dec))),
        "glv_records": max_abs_err(got_r, omsm._glv_stream_packed_plain(ap.x, ap.y, ap.inf, neg1)),
    }
    return {k: {"max_abs_err": v, "launched": launched[k]} for k, v in out.items()} | {
        "lanes": {"decompress": x.shape[1], "glv_records": m},
        "ok_lanes": int(to_reference(got[2]).sum()),
    }


def phase_whisk_lockstep_prove(crs, pres, dev, seed, proofs, device_min):
    """The same K proofs by the lockstep prover: every point operation merged
    across the K provers (64 x 128-lane segmented MSMs on ladder_glv_w3, the
    scales and folds on ladder_w3 and point_op), the merges of device_min
    lanes or more on the card. Byte for byte the thread prover's proofs."""
    cuda_g1.reset_launch_counts()
    metrics().reset()
    os.environ["CURDLEPROOFS_BATCH_PROVE"] = "lockstep"
    default_min, vectors.DEVICE_MIN = vectors.DEVICE_MIN, device_min
    try:
        results, ms = wall_ms(lambda: P.GenerateWhiskShuffleProofs(crs, pres, ProofRng(seed), device=dev), dev)
    finally:
        del os.environ["CURDLEPROOFS_BATCH_PROVE"]
        vectors.DEVICE_MIN = default_min
    launches = _counts()
    rep = metrics().report()
    equal = _post_bytes(results) == _post_bytes(proofs["thread"])
    emit(
        {
            "phase": "whisk_lockstep_prove", "K": len(pres), "ell": crs.ell, "equal_to_thread_prover": equal,
            "wall_s": ms / 1e3, "thread_prover_wall_s": proofs["thread_s"],
            "segmented_msms": rep.get("msm.ladder_seg", {}).get("calls", 0),
            # lockstep.<kind>: every merged step of that kind (calls, seconds);
            # lockstep.<kind>.device: the steps that ran on the card
            "merged_steps": {k: [v["calls"], v["total_time_s"]] for k, v in rep.items()
                             if k.startswith("lockstep.")},
            "spans_s": _spans(rep, ("msm.ladder_seg", "msm.ladder_seg.decompose", "msm.ladder_seg.device",
                                    "msm.ladder_seg.readback")),
            "launches": launches,
        }
    )
    if not equal:
        fail("whisk_lockstep_prove: the lockstep proofs differ from the thread prover's")
    if dev.type == "cuda":
        missing = [k for k in ("ladder_glv_w3", "ladder_w3", "point_op") if not launches[k]]
        if missing:
            fail(f"whisk_lockstep_prove: {missing} never launched")
    return launches


# ---------------------------------------------------------------------------
# phases: the sharded MSM (parallel/) in a world of one and of four ranks
# ---------------------------------------------------------------------------

SHARDED_SPANS = ("pack", "host_prep", "device", "collective", "combine")


def _sharded_calls(bases, scalars, n_ladder, n_sort, mesh):
    """The three sharded entry points at the smoke's sizes: the stream engine
    at the main path's n, the ladder at the ladder branch's widest n, the
    sort engine at n_sort; the stream call's spans read apart, to show which
    path it took."""
    metrics().reset()
    stream = msm_sharded_stream(bases, scalars, mesh=mesh)
    spans = {k: v["calls"] for k, v in metrics().report().items() if k.startswith("msm.sharded")}
    ladder = msm_sharded_ladder(bases[:n_ladder], scalars[:n_ladder], mesh=mesh)
    sort = msm_sharded(bases[:n_sort], scalars[:n_sort], mesh=mesh)
    return {"stream": stream, "ladder": ladder, "sort": sort}, spans


def _sel_engaged(spans) -> bool:
    return spans.get("msm.sharded.sel", 0) >= 1 and not spans.get("msm.sharded.plain")


def _sharded_rank(bases, scalars, n_ladder, n_sort, device, knobs, reps):
    """One rank of sharded_ranks4 (spawned): the three sharded entry points,
    counted, then dryrun_multichip over the world, then `reps` walls of the
    stream call, every rank starting each together (a barrier)."""
    import torch.distributed as dist

    omsm.SEL_MIN_N, ostream._LANES = knobs  # as the parent set them for its sizes
    mesh = make_mesh(device=device)
    cuda_g1.reset_launch_counts()
    results, spans = _sharded_calls(bases, scalars, n_ladder, n_sort, mesh)
    emit({"phase": "sharded_ranks4.rank", "rank": mesh.coords["shard"], "sel_path": _sel_engaged(spans)})
    dryrun_multichip(mesh.shape["shard"], device=device)
    launches = dict(cuda_g1.launch_counts)
    metrics().reset()
    walls = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        msm_sharded_stream(bases, scalars, mesh=mesh)
        walls.append(time.perf_counter() - t0)
    rep = metrics().report()
    return {
        "rank": mesh.coords["shard"], "results": results, "stream_spans": spans, "launches": launches,
        "walls": walls, "span_s": {k: _span_s(rep, f"msm.sharded.{k}", reps) for k in SHARDED_SPANS},
    }


def _turns(plain_fn, sharded_fn, want, reps):
    """reps walls of msm() and of its sharded counterpart, in turns after one
    warm-up each; both checked every call. Returns (plain walls, sharded
    walls, sharded spans' mean seconds, msm()'s spans, all equal)."""
    ok = plain_fn() == want and sharded_fn() == want
    metrics().reset()
    walls = {"msm": [], "sharded": []}
    for _ in range(reps):
        for key, fn in (("msm", plain_fn), ("sharded", sharded_fn)):
            t0 = time.perf_counter()
            ok = fn() == want and ok
            walls[key].append(time.perf_counter() - t0)
    rep = metrics().report()
    spans = {k: _span_s(rep, f"msm.sharded.{k}", reps) for k in SHARDED_SPANS}
    msm_spans = {k[4:]: v["total_time_s"] / reps for k, v in rep.items()
                 if k.startswith("msm.") and not k.startswith("msm.sharded") and v["calls"] >= reps}
    return walls, spans, msm_spans, ok


def phase_sharded_world1(bases, scalars, coef, dev, n_ladder, n_sort):
    """A world of one process, NCCL on the card (gloo in the CPU rehearsal),
    rendezvous by a file in a temporary directory: the three sharded entry
    points against the discrete-log oracle (the stream engine also against
    msm()), then REPS walls of each in turns with msm() on the same inputs
    (the ladder against msm()'s ladder branch, the sort engine against
    msm(method="pippenger")), with the sharded spans: the overhead of the
    sharded path at devices = 1."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="curdle-world1-") as tmp:
        distributed.initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0, backend=backend, device=dev)
        try:
            mesh = make_mesh(device=dev)
            cuda_g1.reset_launch_counts()
            results, spans = _sharded_calls(bases, scalars, n_ladder, n_sort, mesh)
            launches = _counts()
            want = {"stream": dlog_expect(coef, scalars), "ladder": dlog_expect(coef, scalars[:n_ladder]),
                    "sort": dlog_expect(coef, scalars[:n_sort])}
            checks = {k: results[k] == want[k] for k in want}
            checks["stream_equals_msm"] = results["stream"] == msm(bases, scalars, device=dev)
            timing = {}
            for name, n, plain, sharded in (
                ("stream", len(bases), lambda: msm(bases, scalars, device=dev),
                 lambda: msm_sharded_stream(bases, scalars, mesh=mesh)),
                ("ladder", n_ladder, lambda: msm(bases[:n_ladder], scalars[:n_ladder], device=dev),
                 lambda: msm_sharded_ladder(bases[:n_ladder], scalars[:n_ladder], mesh=mesh)),
                ("sort", n_sort, lambda: msm(bases[:n_sort], scalars[:n_sort], method="pippenger", device=dev),
                 lambda: msm_sharded(bases[:n_sort], scalars[:n_sort], mesh=mesh)),
            ):
                walls, sp, msm_sp, ok = _turns(plain, sharded, want[name], REPS)
                checks[f"{name}_timed"] = ok
                timing[name] = {
                    "n": n, "msm_wall_s": _wall_stats(walls["msm"]), "sharded_wall_s": _wall_stats(walls["sharded"]),
                    "sharded_spans_s": sp, "msm_spans_s": msm_sp,
                }
            backend_used = torch.distributed.get_backend()
        finally:
            distributed.shutdown()
    emit(
        {
            "phase": "sharded_world1", "backend": backend_used, "world": 1, "n": len(bases), "c": omsm.pick_window(len(bases)),
            "checks": checks, "sel_path": _sel_engaged(spans), "stream_spans": spans,
            "launches": {k: v for k, v in launches.items() if v}, "reps": REPS, "timing": timing,
        }
    )
    if not all(checks.values()):
        fail(f"sharded_world1: results wrong: {checks}")
    if not _sel_engaged(spans):
        fail(f"sharded_world1: the stream engine did not take the sel path: {spans}")
    if dev.type == "cuda":
        missing = [k for k in ("scan_sel", "gather_u32", "point_op", "point_strided", f"ladder_glv_w{cuda_g1.GLV_W}")
                   if not launches[k]]
        if missing:
            fail(f"sharded_world1: {missing} never launched")
    return launches


def rank_shape_checks(bases, scalars, dev, D: int) -> dict:
    """gather_u32 and scan_sel at the shapes one rank of a world of D gives
    them on the sharded stream engine's sel path (rank 0's block, its first
    window chunk, the prep the engine runs), each against its plain version
    on the same inputs, exact. Run in this process: these launches count
    for no path."""
    n = len(bases)
    local = _local_width(n, D, 32)
    n2 = 2 * local
    L = ostream.pick_lanes(n2)
    T = n2 // L
    sc = np.asarray(ints_to_limbs([s.v for s in scalars[:local]], 16), dtype=np.uint32)
    neg1, order_cm, _, _, sel, _, S = omsm.stream_prep(sc, omsm.pick_window(n), L, glv_split=True, want_sel=True)
    if sel is None:
        fail("rank_shape_checks: rank 0's block overflows every selection slot option")
    ap = og.pack_points(list(bases[:local]), dev)
    packed = omsm._glv_stream_packed(ap.x, ap.y, ap.inf, from_reference(neg1, dev)).contiguous()
    wb = max(1, min(order_cm.shape[0], (1 << 22) // n2))
    idx = from_reference(order_cm[:wb], dev)
    g = ogather.gather_u32_shared(packed, idx)
    g_err = max_abs_err(g, ogather.gather_u32_ref(packed[:, None].expand(-1, wb, -1), idx))
    rec = g.reshape(49, wb * T * L)
    sel_d = from_reference(sel[: wb * T], dev)
    got = ostream.scan_records_sel(rec, sel_d, wb, T, L, S)
    want = ostream.scan_records_sel_ref(rec, sel_d, wb, T, L, S)
    return {
        "local": local, "lanes": n2, "W": wb, "T": T, "L": L, "S": S,
        "gather_u32_max_abs_err": g_err, "scan_sel_max_abs_err": max_abs_err(list(got), list(want)),
    }


def phase_sharded_ranks4(bases, scalars, coef, dev, n_ladder, n_sort, knobs):
    """Four processes spawned on the one card (each `device=dev`), joined
    over gloo (NCCL refuses two ranks on one card): the three sharded entry
    points, every rank's results equal to each other and to the oracle,
    the sel path on every rank, then dryrun_multichip(4) (its (2, 2) dp x
    sp layout included), and each rank's walls of the stream call. The walls
    are four ranks sharing one card: not a scaling number. Before the world
    starts, gather_u32 and scan_sel are held against their plain versions at
    one rank's shapes (rank_shape_checks)."""
    shapes = rank_shape_checks(bases, scalars, dev, 4)
    rank_dev = str(distributed.local_device(dev))  # "cuda:0" on the card: every rank on the one card
    ranks = distributed.spawn(
        _sharded_rank, 4, args=(bases, scalars, n_ladder, n_sort, rank_dev, knobs, REPS),
        backend="gloo", device=rank_dev, timeout=900,
    )
    want = {"stream": dlog_expect(coef, scalars), "ladder": dlog_expect(coef, scalars[:n_ladder]),
            "sort": dlog_expect(coef, scalars[:n_sort])}
    checks = {k: all(r["results"][k] == want[k] for r in ranks) for k in want}
    launches = {k: sum(r["launches"][k] for r in ranks) for k in cuda_g1.KERNEL_NAMES}
    sel = [_sel_engaged(r["stream_spans"]) for r in ranks]
    emit(
        {
            "phase": "sharded_ranks4", "backend": "gloo", "world": 4, "device_each_rank": rank_dev, "n": len(bases),
            "checks": checks, "dryrun_multichip_4": "passed on every rank", "sel_path_by_rank": sel,
            "rank_shape_kernels": shapes,
            "launches": {k: v for k, v in launches.items() if v},
            "walls_note": "four ranks sharing one card: not a scaling number",
            "stream_wall_s_by_rank": [_wall_stats(r["walls"]) for r in ranks],
            "stream_spans_s_by_rank": [r["span_s"] for r in ranks],
        }
    )
    if not all(checks.values()):
        fail(f"sharded_ranks4: results wrong: {checks}")
    if shapes["gather_u32_max_abs_err"] or shapes["scan_sel_max_abs_err"]:
        fail(f"sharded_ranks4: kernels disagree with their plain versions at a rank's shapes: {shapes}")
    if not all(sel):
        fail(f"sharded_ranks4: the stream engine did not take the sel path on every rank: {sel}")
    if dev.type == "cuda":
        missing = [k for k in ("scan_sel", "gather_u32", "point_op", "point_strided", f"ladder_glv_w{cuda_g1.GLV_W}")
                   if not launches[k]]
        if missing:
            fail(f"sharded_ranks4: {missing} never launched")
    return launches


# ---------------------------------------------------------------------------
# phase: each kernel at the main path's shapes, timed, beside its bound
# ---------------------------------------------------------------------------


def strided_edge_check(aq) -> dict:
    """The prefix scan's schedule (`ops.scan.scan_schedule`) on the card over
    3 x 256 lanes of the records of aq, SMALL_WIDTH lowered to 4 (six levels
    above the fixed-width steps), at every thread group and at the picked
    ones, against the plain twin."""
    rec = torch.cat([aq.x, aq.y, aq.inf.unsqueeze(0).to(torch.int32)])[:, : 3 * 256]
    rec = rec.reshape(49, 3, 256).contiguous()
    saved, oscan.SMALL_WIDTH = oscan.SMALL_WIDTH, 4
    try:
        want = oscan.inclusive_scan_levels_ref(rec)
        by_group = {
            str(g): torch.equal(oscan._run_schedule(rec, lambda b, st, g=g: cuda_g1.point_strided(b, st, g)), want)
            for g in cuda_g1.GROUPS
        }
        by_group["picked"] = torch.equal(oscan.inclusive_scan_records(rec), want)
    finally:
        oscan.SMALL_WIDTH = saved
    return {"equal": all(by_group.values()), "equal_by_group": by_group, "rows": 3, "lanes": 256, "small_width": 4}


def scan_launch_times(rec, table) -> dict:
    """Each launch of the prefix scan over records rec (49, rows, n) alone,
    by CUDA graph, on the buffers one run of the schedule leaves, beside
    `point_op` (the contiguous point kernel, the same group) at the launch's
    width on columns of table, the scan's (72, rows, n) output; and the
    sums by kind (a level up, a fixed-width step, a level down)."""
    rows = rec.shape[1]
    kept = []
    oscan._run_schedule(rec, lambda bufs, st: (cuda_g1.point_strided(bufs, st), kept.append((bufs, st))))
    names = {oscan.UP: "up", oscan.ANY: "step", oscan.DOWN: "down"}
    k4_ms, per_launch = {}, []
    for bufs, st in kept:
        m = rows * st.lanes
        if m not in k4_ms:
            a, b = (og.JPoints(*(table[24 * k : 24 * (k + 1)].reshape(24, -1)[:, o : o + m].contiguous()
                                 for k in range(3))) for o in (0, m))
            k4_ms[m] = graph_ms(lambda a=a, b=b: cuda_g1.jadd(a, b), 5)
        per_launch.append({"kind": names[st.kind], "lanes": st.lanes, "group": cuda_g1.point_group(m, "jadd"),
                           "ms": graph_ms(lambda b=bufs, s_=st: cuda_g1.point_strided(b, s_), 5),
                           "point_op_ms": k4_ms[m]})
    out = {"per_launch": per_launch}
    for key in ("ms", "point_op_ms"):
        out[f"{key}_by_kind"] = {k: sum(r[key] for r in per_launch if r["kind"] == k) for k in names.values()}
    return out


def scan_least_bytes(launches, rows: int) -> int:
    """Bytes the launches of `ops.scan.scan_schedule` move at least over
    `rows` rows: every column a launch reads, once (49 words a record, 72 a
    point; a level down's copied prefix is the column its p reads a lane
    on), and every column it writes (72 words)."""
    total = 0
    for st in launches:
        cols = {}
        for op in (st.p, st.q, st.copy):
            if op is not None and op.lo < st.lanes:
                cols.setdefault(op.buf, []).append(op.off + op.step * np.arange(op.lo, st.lanes))
        total += sum((49 if b == oscan.RECORDS else 72) * np.unique(np.concatenate(c)).size for b, c in cols.items())
        total += 72 * st.lanes * (1 + (st.copy_out is not None))
    return 4 * rows * total


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


def record_point_launches(fn, dev) -> tuple:
    """Run fn() and count the point operations it hands the card: (fn()'s
    result, (body, m) -> launches). On the CPU (the rehearsal) the plain
    complete add is counted instead."""
    seen = {}

    def note(body, m):
        seen[(body, m)] = seen.get((body, m), 0) + 1

    if dev.type == "cuda":
        real = cuda_g1.point_op

        def spy(body, coords, qinf=None, group=None):
            note(body, coords[0].shape[-1])
            return real(body, coords, qinf, group)

        owner, attr = cuda_g1, "point_op"
    else:
        real = og._jadd_formulas

        def spy(p, q, handle_doubling=True):
            note("jadd", p.x[0].numel())
            return real(p, q, handle_doubling)

        owner, attr = og, "_jadd_formulas"
    setattr(owner, attr, spy)
    try:
        result = fn()
    finally:
        setattr(owner, attr, real)
    return result, seen


# widths between the main paths' own, to place the group thresholds
POINT_PROBE_WIDTHS = (1024, 2560, 12288, 16384, 28672, 61440)
LADDER_PROBE_WIDTHS = (1024, 2048, 3072, 4096, 6144)


def point_group_sweep(widths, launches, p_src, q_src, packed, dev, timer):
    """point_op at each width, each body at each thread group in turns (two
    rounds), each against the plain version bit for bit. Operands: the
    boundary add's p and q of the main path's msm() (lanes taken in order,
    repeated past its width) and its affine point records as jmadd's q. Two
    times a call: `ms` by CUDA events around back-to-back wrapper calls (the
    host's launch overhead shows where it is longer than the kernel) and
    `graph_ms` from a CUDA graph of 20 calls (device time). Per width and
    body the bound and the group the wrapper picks; `launches` (name ->
    (body, m) -> count, from record_point_launches) gives each path's
    launches per call and the sum of launches x graph_ms at group 1 and at
    the picked groups."""
    cuda = dev.type == "cuda"
    dtimer = (lambda fn, iters: graph_ms(fn, 4 * iters)) if cuda else timer
    bodies = {"jadd": ("jadd", 9), "jdbl": ("dbl", 6), "jmadd": ("madd", 8)}  # products, field elements moved
    n_src = p_src.x.shape[-1]
    graph = {}  # (body, m) -> {group: mean graph ms}
    out = {"widths": []}
    for m in widths:
        take = torch.arange(m, device=p_src.x.device) % n_src
        pj = og.JPoints(*(t[:, take].contiguous() for t in p_src))
        qj = og.JPoints(*(t[:, take].contiguous() for t in q_src))
        rec = packed[:, take % packed.shape[1]]
        aq = og.APoints(rec[:24].contiguous(), rec[24:48].contiguous(), rec[48] != 0)
        calls = {
            "jadd": (lambda g: cuda_g1.jadd(pj, qj, g) if cuda else og.jadd(pj, qj), lambda: og._jadd_formulas(pj, qj)),
            "jdbl": (lambda g: cuda_g1.jdbl(pj, g) if cuda else og.jdbl(pj), lambda: og._jdbl_formulas(pj)),
            "jmadd": (lambda g: cuda_g1.jmadd(pj, aq, g) if cuda else og.jmadd(pj, aq), lambda: og._jmadd_formulas(pj, aq)),
        }
        res = {"m": m, "bodies": {}}
        for body, (fn, plain) in calls.items():
            want = list(plain())
            op, fields = bodies[body]
            t_ops = m * MONT_PER_OP[op] * MULS_PER_MONT / INT32_MAD_PER_S * 1e3
            t_bytes = 4 * m * (24 * fields + (body == "jmadd")) / HBM_BYTES_PER_S * 1e3
            b = {
                "group_picked": cuda_g1.point_group(m, body),
                "equal_by_group": {str(g): max_abs_err(list(fn(g)), want) == 0 for g in cuda_g1.GROUPS},
                "ms_by_group": {str(g): [] for g in cuda_g1.GROUPS},
                "graph_ms_by_group": {str(g): [] for g in cuda_g1.GROUPS},
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            for _ in range(2):
                for g in cuda_g1.GROUPS:
                    b["ms_by_group"][str(g)].append(timer(lambda g=g: fn(g), 5))
                    b["graph_ms_by_group"][str(g)].append(dtimer(lambda g=g: fn(g), 5))
            graph[(body, m)] = {g: float(np.mean(v)) for g, v in b["graph_ms_by_group"].items()}
            res["bodies"][body] = b
        out["widths"].append(res)
    for path, counts in launches.items():
        tot = {"launches": {f"{b} {m}": c for (b, m), c in sorted(counts.items())}, "group_1_ms": 0.0, "picked_ms": 0.0}
        for (body, m), c in counts.items():
            if (body, m) in graph:
                tot["group_1_ms"] += c * graph[(body, m)]["1"]
                tot["picked_ms"] += c * graph[(body, m)][str(cuda_g1.point_group(m, body))]
        out[f"per_{path}"] = tot
    return out


def w1_products(sc_m) -> int:
    """Montgomery products ladder_w1 needs on these (16, m) scalar limbs: a
    doubling a bit, one mixed add per set bit."""
    m = sc_m.shape[1]
    set_bits = int(np.count_nonzero(omsm.host_digits(sc_m, 1, bits=255)))
    return m * 255 * MONT_PER_OP["dbl"] + set_bits * MONT_PER_OP["madd"]


def w3_products(sc_m) -> int:
    """Montgomery products ladder_w3 needs on these (16, m) scalar limbs:
    three doublings an iteration, one add per non-zero digit."""
    m = sc_m.shape[1]
    nonzero = int(np.count_nonzero(omsm.host_digits(sc_m, 3, bits=255)))
    return m * 85 * 3 * MONT_PER_OP["dbl"] + nonzero * MONT_PER_OP["jadd"]


def ladder_width(fn, want, timer, m, picked, products, nbytes) -> dict:
    """One width of a ladder's group sweep: fn(g) at each thread group
    against `want` bit for bit, then timed at each group in turns (two
    rounds), beside the bound (`products` Montgomery products against
    `nbytes` moved) and the group the wrapper picks."""
    res = {
        "lanes": m,
        "group_picked": picked,
        "equal_by_group": {str(g): max_abs_err(list(fn(g)), want) == 0 for g in cuda_g1.GROUPS},
        "ms_by_group": {str(g): [] for g in cuda_g1.GROUPS},
        "montgomery_products": products,
        "bound_ms": max(products * MULS_PER_MONT / INT32_MAD_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
    }
    for _ in range(2):
        for g in cuda_g1.GROUPS:
            res["ms_by_group"][str(g)].append(timer(lambda g=g: fn(g), 3))
    return res


def ladder_group_sweep(bases, sc, dev, timer, widths, want):
    """The ladder_w3 launch alone (its table built beforehand) at each width,
    at each thread group in turns (two rounds), each against `want` (the
    plain ladder's (24, n) outputs on the same lanes, n >= every width) bit
    for bit, beside its bound and the group the wrapper picks."""
    cuda = dev.type == "cuda"
    out = {}
    for m in widths:
        ap = og.pack_points(list(bases[:m]), dev)
        sc_m = from_reference(sc[:, :m], dev)
        if cuda:
            table = cuda_g1.ladder_w3_table(ap)
            fn = lambda g: cuda_g1.ladder_w3(table, sc_m, g)  # noqa: E731
        else:
            fn = lambda g: tuple(og._scalar_mul_w3_plain(ap, sc_m))  # noqa: E731
        out[str(m)] = ladder_width(fn, [t[:, :m] for t in want], timer, m, cuda_g1.ladder_group(m),
                                   w3_products(sc[:, :m]), 4 * m * (7 * 72 + 16 + 72))
    return out


def w1_group_sweep(ap, sc, dev, timer, widths, want):
    """The ladder_w1 launch at each width, its lanes the n lanes of the
    affine points `ap` and host scalar limbs `sc` over and over, at each
    thread group in turns (two rounds), each against `want` (the plain
    ladder's (24, n) outputs on those n lanes, tiled the same way: a lane's
    result depends on its own inputs only) bit for bit, beside its bound and
    the group the wrapper picks."""
    cuda = dev.type == "cuda"
    n = sc.shape[1]
    out = {}
    for m in widths:
        take = np.arange(m) % n
        take_d = torch.from_numpy(take).to(ap.x.device)
        apm = og.APoints(*(t[..., take_d].contiguous() for t in ap))
        sc_m = np.ascontiguousarray(sc[:, take])
        sc_d = from_reference(sc_m, dev)
        if cuda:
            fn = lambda g: tuple(cuda_g1.scalar_mul_w1(apm, sc_d, g))  # noqa: E731
        else:
            fn = lambda g: tuple(og.scalar_mul_w1(apm, sc_d))  # noqa: E731
        out[str(m)] = ladder_width(fn, [t[:, take_d] for t in want], timer, m, cuda_g1.ladder_w1_group(m),
                                   w1_products(sc_m), 4 * m * (48 + 1 + 16 + 72))
    return out


GLV_PROBE_WIDTHS = (124, 1024, 4096, 6144, 8192, 12288)  # one shuffle, the protocol's, the segmented prover's


def glv_group_sweep(ap, halves, w, dev, timer, widths, want):
    """The GLV ladder of window width w alone at each width (the first m
    lanes of the affine points `ap` and of the host half-scalars `halves` =
    (|k1| limbs, sign of k1, k2 limbs)), at each thread group in turns (two
    rounds), each against `want` (the plain ladder's (24, n) outputs on the
    same lanes, n >= every width) bit for bit, beside its bound and the group
    the wrapper picks."""
    cuda = dev.type == "cuda"
    h1, neg1, h2 = halves
    out = {}
    for m in widths:
        apm = og.APoints(ap.x[:, :m].contiguous(), ap.y[:, :m].contiguous(), ap.inf[:m].contiguous())
        args = (apm, *(from_reference(np.ascontiguousarray(h[..., :m]), dev) for h in (h1, neg1, h2)))
        if cuda:
            fn = lambda g: tuple(cuda_g1.scalar_mul_glv(*args, w=w, group=g))  # noqa: E731
        else:
            fn = lambda g: tuple(og._scalar_mul_glv_plain(*args, w=w))  # noqa: E731
        out[str(m)] = ladder_width(fn, [t[:, :m] for t in want], timer, m, cuda_g1.ladder_glv_group(m, w),
                                   glv_ladder_products(h1[:, :m], h2[:, :m], w), 4 * m * (48 + 2 + 18 + 72))
    return out


def in_turns(calls, rounds: int, timer) -> dict:
    """timer(call) of each call, `rounds` rounds in turns (the order reversed
    every other round): name -> the rounds' readings."""
    out = {k: [] for k in calls}
    for r in range(rounds):
        for k in list(calls) if r % 2 == 0 else reversed(list(calls)):
            out[k].append(timer(calls[k]))
    return out


def count_cuda_ops(calls) -> dict:
    """The PyTorch ops each call runs that touch a CUDA tensor (argument or
    result), counted under a dispatch mode, by op."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_op = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_flatten((args, kwargs, out))[0]):
                self.by_op[str(func)] = self.by_op.get(str(func), 0) + 1
            return out

    res = {}
    for name, fn in calls.items():
        with Counter() as counter:
            fn()
        res[name] = {"ops": sum(counter.by_op.values()), "by_op": counter.by_op}
    return res


def short_names(by_name, width: int = 100) -> dict:
    """A trace's launches and ms by kernel name, the names cut to `width`
    characters (entries that then share a name are summed)."""
    out = {}
    for k, v in by_name.items():
        e = out.setdefault(k[:width], {"launches": 0, "ms": 0.0})
        e["launches"] += v["launches"]
        e["ms"] += v["ms"]
    return out


def phase_trace_msm(bases, scalars, coef, dev):
    """One warm msm() at n = 2^16 under `utils.profiling.device_trace`: from
    the trace, the kernels' summed time (all, and the package's own), the
    device's busy share of the call's wall and the launches by name. Then
    msm()'s device span with the GLV records on their kernel and on the
    plain chain, REPS calls each in turns (medians)."""
    want = dlog_expect(coef, scalars)
    msm(bases, scalars, device=dev)  # warm
    with tempfile.TemporaryDirectory() as logdir:
        with device_trace(logdir) as prof:
            got, wall = wall_ms(lambda: msm(bases, scalars, device=dev), dev)
        trace_bytes = sum(os.path.getsize(os.path.join(logdir, f)) for f in os.listdir(logdir))
    summary = trace_summary(prof, wall / 1e3)
    copies = ("Memcpy", "Memset")
    kernels = {k: v for k, v in summary["by_name"].items() if not k.startswith(copies)}
    ours = {k: v for k, v in kernels.items() if k.startswith(("curdle::", "void curdle::"))}
    kernel_fn, checks = omsm._glv_stream_packed, [got == want]

    def device_span(records_fn):
        omsm._glv_stream_packed = records_fn
        try:
            metrics().reset()
            checks.append(msm(bases, scalars, device=dev) == want)
            return metrics().report()["msm.stream.device"]["total_time_s"]
        finally:
            omsm._glv_stream_packed = kernel_fn

    spans = in_turns({"kernel": lambda: device_span(kernel_fn),
                      "plain": lambda: device_span(omsm._glv_stream_packed_plain)}, REPS, lambda fn: fn())
    ok = all(checks)
    emit(
        {
            "phase": "trace_msm", "n": len(bases), "dlog_check": ok, "trace_bytes": trace_bytes,
            "kernel_ms": sum(v["ms"] for v in kernels.values()),
            "kernel_launches": sum(v["launches"] for v in kernels.values()),
            "port_kernel_ms": sum(v["ms"] for v in ours.values()),
            "port_kernel_launches": sum(v["launches"] for v in ours.values()),
            "device_ms": summary["device_ms"], "busy_ms": summary["busy_ms"], "window_ms": summary["window_ms"],
            "busy_share": summary["busy_share"],
            "by_name": short_names(summary["by_name"]),
            "device_span_s": {k: {"median": float(np.median(v)), "all": v} for k, v in spans.items()},
        }
    )
    if not ok:
        fail("trace_msm: msm() is wrong")
    if dev.type == "cuda" and not ours:
        fail("trace_msm: the trace holds no kernel of the package on the card")


def phase_kernel_times(bases, scalars, dev, launches, by_phase, n_glv, n_vec, n_vec_small, coef, point_widths,
                       decode_encs, variants=False):
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
    timer = cuda_ms if dev.type == "cuda" else (lambda fn, iters: wall_ms(fn, dev)[1])

    stream_shape = {"W": W, "T": T, "L": L, "S": S, "n": n2}

    plain_out = {}  # name -> the plain version's outputs of its row

    def row(name, replaces, got_fn, want_fn, ops, nbytes, library_fn=None, iters=5,
            source=KERNELS_CU, shape=stream_shape):
        got, ms_first = wall_ms(got_fn, dev)
        want, plain_ms = wall_ms(want_fn, dev)
        plain_out[name] = want
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

    # gather_u32: the sorted-order gather of the point records, as the main
    # path calls it (the record-major copy included), beside its parts, the
    # other layout, torch.gather and torch.index_select
    tab3 = packed.unsqueeze(1)
    flat_idx = idx_d.reshape(1, W * n2)
    lib_idx = flat_idx.to(torch.int64).unsqueeze(0).expand(49, -1, -1)
    g = row(
        "gather_u32",
        "curdleproofs_tpu/ops/gather.py:82",
        lambda: ogather.gather_u32_shared(packed, idx_d),
        lambda: ogather.gather_u32_ref(tab3, flat_idx).reshape(49, W, n2),
        ops=0,
        nbytes=4 * (packed.numel() + idx_d.numel() + 49 * W * n2),
        library_fn=lambda: torch.gather(tab3, 2, lib_idx),
    )
    del lib_idx
    rec_tab = ogather.record_major(tab3)
    rows[-1].update(
        layout="records" if ogather.records_pay(49, 1, n2, W, n2) else "rows",
        copy_ms=timer(lambda: ogather.record_major(tab3), 5),
        kernel_ms=timer(lambda: ogather.gather_layout(rec_tab, idx_d, 49, records=True), 5),
        rows_layout_ms=timer(lambda: ogather.gather_layout(tab3, idx_d, 49, records=False), 5),
        index_select_records_ms=timer(lambda: torch.index_select(rec_tab[0], 0, flat_idx[0].to(torch.int64)), 5),
    )
    del rec_tab
    # both layouts, the record-major copy included, for the sorted-order
    # gather of msm() at n/4 and n/2 (widths are padded to powers of two, so
    # these are the two narrower stream shapes), from those scalars' host prep
    layout_probe = {}
    for n_p in (n // 4, n // 2):
        c_p = omsm.pick_window(n_p)
        d_p = omsm.host_digits(np.concatenate([s1[:, :n_p], s2[:, :n_p]], axis=1).astype(np.uint32), c_p, bits=130)
        W_p, n2_p = d_p.shape
        idx_p = from_reference(omsm.stream_host_prep(d_p, c_p, ostream.pick_lanes(n2_p))[0], dev)
        tab_p = packed[:, :n2_p].contiguous().unsqueeze(1)
        by_rows = ogather.gather_layout(tab_p, idx_p, 49, records=False)
        layout_probe[str(n_p)] = {
            "table": [49, 1, n2_p],
            "idx": [W_p, n2_p],
            "table_bytes": 4 * tab_p.numel(),
            "layout": "records" if ogather.records_pay(49, 1, n2_p, W_p, n2_p) else "rows",
            "records_ms": timer(lambda: ogather.gather_layout(ogather.record_major(tab_p), idx_p, 49, records=True), 5),
            "rows_ms": timer(lambda: ogather.gather_layout(tab_p, idx_p, 49, records=False), 5),
            "max_abs_err": max_abs_err(
                ogather.gather_layout(ogather.record_major(tab_p), idx_p, 49, records=True), by_rows
            ),
        }
        del by_rows
    rows[-1]["layout_probe"] = layout_probe
    # rowwise_gather: the three stages of the routed gather of the same records,
    # at the shape the routed path launches them (a chunk of ROUTE_WINDOW_BATCH
    # windows) and, beside it, with all W windows in one launch; tables from
    # the native route solver
    rr, rc = oroute.pick_rc(n2, omsm.ROUTE_MIN_FACTOR)
    t0 = time.perf_counter()
    route_tables = tuple(from_reference(t, dev) for t in oroute.decompose(rr, rc, order_cm))
    solve_s = time.perf_counter() - t0
    R = 49
    g_direct = g  # what the direct gather made of the same records

    def routed_stages(Wk, rounds=1):
        """The three launches of ops.gather.routed_gather over the first Wk
        windows, one at a time, with the layout step before each; each stage
        and torch.gather on it timed in `rounds` rounds of turns (kernel
        first in even rounds, torch.gather first in odd ones), medians."""
        i1, i2, i3 = (t[:Wk].contiguous() for t in route_tables)
        layouts = {
            "stage1": lambda: (packed.reshape(R, rr, rc).transpose(0, 1).contiguous(),
                               i1.transpose(0, 1).reshape(rr, Wk * rc).contiguous()),
            "stage2": lambda s1: (s1.reshape(rr, R, Wk, rc).permute(2, 3, 1, 0).reshape(Wk * rc, R, rr).contiguous(),
                                  i2.reshape(Wk * rc, rr).contiguous()),
            "stage3": lambda s2: (s2.reshape(Wk, rc, R, rr).permute(0, 3, 2, 1).reshape(Wk * rr, R, rc).contiguous(),
                                  i3.reshape(Wk * rr, rc).contiguous()),
            "output": lambda s3: s3.reshape(Wk, rr, R, rc).permute(2, 0, 1, 3).reshape(R, Wk, n2),
        }
        stages, prev = [], ()
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0}
        for name in ("stage1", "stage2", "stage3"):
            tab, idx = layouts[name](*prev)
            layout_ms = timer(lambda: layouts[name](*prev), 3)
            out_s = ogather.rowwise_gather(tab, idx)
            want_s, plain_ms = wall_ms(lambda: ogather.rowwise_gather_ref(tab, idx), dev)
            G, _, K = tab.shape
            lib_idx_s = idx.to(torch.int64).unsqueeze(1).expand(-1, R, -1)
            turns = {"ms": [], "library_ms": []}
            calls = {"ms": lambda: ogather.rowwise_gather(tab, idx), "library_ms": lambda: torch.gather(tab, 2, lib_idx_s)}
            for r in range(rounds):
                for key in ("ms", "library_ms") if r % 2 == 0 else ("library_ms", "ms"):
                    turns[key].append(timer(calls[key], 5))
            st = {
                "stage": name, "G": G, "K": K, "M": idx.shape[1],
                "max_abs_err": max_abs_err(out_s, want_s),
                "ms": float(np.median(turns["ms"])),
                "plain_ms": plain_ms,
                "bound_ms": 4 * (tab.numel() + idx.numel() + out_s.numel()) / HBM_BYTES_PER_S * 1e3,
                "library_ms": float(np.median(turns["library_ms"])),
                "layout_before_ms": layout_ms,
            }
            if rounds > 1:
                st.update(ms_rounds=turns["ms"], library_ms_rounds=turns["library_ms"])
            stages.append(st)
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                tot[key] += st[key]
            tot["max_abs_err"] = max(tot["max_abs_err"], st["max_abs_err"])
            del want_s, lib_idx_s
            prev = (out_s,)
        tot["max_abs_err"] = max(
            tot["max_abs_err"],
            max_abs_err(layouts["output"](*prev), g_direct[:, :Wk]),
            max_abs_err(ogather.routed_gather(packed, i1, i2, i3), g_direct[:, :Wk]),
        )
        tot.update(
            W=Wk,
            stages=stages,
            output_layout_ms=timer(lambda: layouts["output"](*prev).contiguous(), 3),
            routed_gather_ms=timer(lambda: ogather.routed_gather(packed, i1, i2, i3), 3),
        )
        return tot

    Wc = min(W, omsm.ROUTE_WINDOW_BATCH)
    chunk, whole = routed_stages(Wc, rounds=5), routed_stages(W)
    chunk_tables = tuple(t[:Wc].contiguous() for t in route_tables)  # one chunk's, for --product-variants
    rows.append(
        {
            "name": "rowwise_gather",
            "route": "cuda",
            "source": GATHER_CU,
            "replaces": "curdleproofs_tpu/ops/gather.py:265",
            "launches": launches["rowwise_gather"],
            "launches_by_phase": {ph: c_["rowwise_gather"] for ph, c_ in by_phase.items() if c_["rowwise_gather"]},
            "max_abs_err": max(chunk["max_abs_err"], whole["max_abs_err"]),
            "ms": chunk["ms"],
            "plain_ms": chunk["plain_ms"],
            "bound_ms": chunk["bound_ms"],
            "bound_by": "bytes",
            "library_ms": chunk["library_ms"],
            "shape": {"r": rr, "c": rc, "W": Wc, "R": R, "three_stages_summed": True,
                      "chunks_per_msm": -(-W // Wc), "medians_of_rounds_in_turns": 5},
            "stages": chunk["stages"],
            "output_layout_ms": chunk["output_layout_ms"],
            "routed_gather_ms": chunk["routed_gather_ms"],
            "all_windows_one_launch": whole,
            "direct_gather_ms_all_windows": rows[0]["ms"],
            "route_solve_s_all_windows_one_thread": solve_s,
        }
    )
    del route_tables, g_direct, chunk, whole
    rec = g.reshape(49, W * T * L)
    madd_ops = W * n2 * MONT_PER_OP["madd"] * MULS_PER_MONT
    k_main = ostream.split_steps(T)
    bsel, totals, _flags = row(
        "scan_sel",
        "curdleproofs_tpu/ops/stream_scan.py:163",
        lambda: ostream.scan_records_sel(rec, sel_d, W, T, L, S),
        lambda: ostream.scan_records_sel_ref(rec, sel_d, W, T, L, S),
        ops=madd_ops,
        nbytes=4 * (rec.numel() + sel_d.numel() + 72 * W * T * S + 72 * W * L + W),
        iters=3,
        shape=dict(stream_shape, split=k_main),
    )
    # the kernel at every split; lane totals on a 256-lane sample against the
    # default split's, as points (the plain scan at full shape runs only once)
    sample = torch.arange(256, device=dev)
    win, lane = sample % W, (sample * 37) % L
    sweep = {}
    for k in (1, 2, 4, 8, 16, 32):
        if k > T:
            continue
        got_k = ostream.scan_records_sel(rec, sel_d, W, T, L, S, split=k)
        sweep[str(k)] = {
            "ms": timer(lambda k=k: ostream.scan_records_sel(rec, sel_d, W, T, L, S, split=k), 3),
            "totals_sample_equal": same_points(got_k[1][:, win, lane], totals[:, win, lane]),
            "flags": int(got_k[2].sum()),
        }
        del got_k
    rows[-1]["split_sweep"] = sweep
    row(
        "scan_full",
        "curdleproofs_tpu/ops/stream_scan.py:93",
        lambda: ostream.scan_records(rec, W, T, L),
        lambda: ostream.scan_records_ref(rec, W, T, L),
        ops=madd_ops,
        nbytes=4 * (rec.numel() + 72 * W * T * L + 72 * W * L),
        iters=3,
        shape=dict(stream_shape, split=k_main),
    )
    # the complete scan at every split, two rounds in turns (K ascending,
    # then descending), each bit-equal to the plain version at its split
    full_sweep = {}
    splits = [k for k in (1, 2, 4, 8, 16, 32) if k <= T]
    for k in splits:
        want_k, plain_ms = (plain_out["scan_full"], None) if k == k_main else wall_ms(
            lambda k=k: ostream.scan_records_ref(rec, W, T, L, split=k), dev)
        full_sweep[str(k)] = {
            "max_abs_err": max_abs_err(list(ostream.scan_records(rec, W, T, L, split=k)), list(want_k)),
            "plain_ms": plain_ms,
            "ms": [],
        }
        del want_k
    for rnd in range(2):
        for k in splits if rnd == 0 else reversed(splits):
            full_sweep[str(k)]["ms"].append(timer(lambda k=k: ostream.scan_records(rec, W, T, L, split=k), 3))
    rows[-1]["split_sweep"] = full_sweep
    # the stitch's two gathers, in the layout the wrapper picks and in the
    # other one (the record-major copy included)
    lane_tab = totals  # any (72, W, L) table of valid points serves as offsets
    stitch = {}
    for name, (tab, ix) in {"bsel": (bsel, bpos_d), "lane_offsets": (lane_tab, lidx_d)}.items():
        _, Wk, Nk = tab.shape
        pay = ogather.records_pay(72, Wk, Nk, W, ix.shape[1])
        stitch[name] = {
            "shape": [72, Wk, Nk, ix.shape[1]],
            "layout": "records" if pay else "rows",
            "records_ms": timer(lambda: ogather.gather_layout(ogather.record_major(tab), ix, 72, records=True), 5),
            "rows_ms": timer(lambda: ogather.gather_layout(tab, ix, 72, records=False), 5),
            "max_abs_err": max_abs_err(ogather.gather_u32(tab, ix), ogather.gather_u32_ref(tab, ix)),
        }
    rows[0]["stitch_gathers"] = stitch
    # point_op: the boundary stitch, local prefix + lane offset, (24, W, B-1)
    bl = omsm._split72(ogather.gather_u32(bsel, bpos_d))
    lo = omsm._split72(ogather.gather_u32(lane_tab, lidx_d))
    m = bl.x[0].numel()
    # the calls --product-variants times under each variant build
    variant_cases = {
        "gather_u32": (lambda: (ogather.gather_u32_shared(packed, idx_d),), 5, "kernels.cu"),
        "rowwise_gather": (lambda: (ogather.routed_gather(packed, *chunk_tables),), 5, "gather.cu"),
        "scan_full": (lambda: ostream.scan_records(rec, W, T, L), 3, "kernels.cu"),
        "scan_full_split32": (lambda: ostream.scan_records(rec, W, T, L, split=32), 3, "kernels.cu"),
        "scan_sel": (lambda: ostream.scan_records_sel(rec, sel_d, W, T, L, S), 3, "kernels.cu"),
        "scan_sel_split1": (lambda: ostream.scan_records_sel(rec, sel_d, W, T, L, S, split=1), 3, "kernels.cu"),
        "point_op": (lambda: tuple(cuda_g1.jadd(bl, lo)), 5, "kernels.cu"),
        "point_op_group1": (lambda: tuple(cuda_g1.jadd(bl, lo, 1)), 5, "kernels.cu"),
    }
    row(
        "point_op",
        "curdleproofs_tpu/ops/pallas_g1.py:130",
        lambda: tuple(cuda_g1.jadd(bl, lo)) if dev.type == "cuda" else tuple(og.jadd(bl, lo)),
        lambda: tuple(og._jadd_formulas(bl, lo)),
        ops=m * MONT_PER_OP["jadd"] * MULS_PER_MONT,
        nbytes=4 * 24 * 9 * m,
    )
    # the same kernel at every width the main path's msm() at this n and its
    # scale_points at each vector width launched it (recorded in those
    # phases' counted runs), and at probe widths between, at every thread group
    launches_by_path = {k: point_widths[k] for k in ("msm", f"scale_points_{n_vec}", f"scale_points_{n_vec_small}")}
    widths = sorted({k[1] for c in launches_by_path.values() for k in c} | {w for w in POINT_PROBE_WIDTHS if w < n})
    flat = lambda a: og.JPoints(*(t.reshape(24, -1) for t in a))  # noqa: E731
    rows[-1].update(
        group=cuda_g1.point_group(m),
        group_sweep=point_group_sweep(widths, launches_by_path, flat(bl), flat(lo), packed, dev, timer),
    )
    # point_strided: the sort engines' prefix scan (ops/scan.py::scan_schedule)
    # over one chunk of gathered records at the benchmark's shape, 8 windows
    # of 2^19 lanes (8 x 256 on the CPU), against its plain twin and against
    # the composition it replaced (lift, inclusive_scan, cat); each launch
    # alone by CUDA graph beside the contiguous point kernel at its width
    s_rows, s_width = (8, 1 << 19) if dev.type == "cuda" else (8, 256)
    gen = torch.Generator(device=dev).manual_seed(16)
    s_idx = torch.randint(0, packed.shape[-1], (s_rows, s_width), generator=gen, device=dev, dtype=torch.int32)
    s_rec = ogather.gather_u32_shared(packed, s_idx)
    s_launches = oscan.scan_schedule(s_width, oscan.SMALL_WIDTH)[1]
    s_adds = s_rows * sum(st.lanes for st in s_launches)

    def old_scan():
        P = oscan.inclusive_scan(og.lift(og.APoints(s_rec[:24], s_rec[24:48], s_rec[48] != 0)))
        return torch.cat([P.x, P.y, P.z], dim=0)

    s_table = row(
        "point_strided",
        "curdleproofs_tpu/ops/scan.py:123",
        lambda: oscan.inclusive_scan_records(s_rec),
        lambda: oscan.inclusive_scan_levels_ref(s_rec),
        ops=s_adds * MONT_PER_OP["jadd"] * MULS_PER_MONT,
        nbytes=scan_least_bytes(s_launches, s_rows),
        shape={"rows": s_rows, "lanes": s_width, "small_width": oscan.SMALL_WIDTH, "launches": len(s_launches),
               "complete_adds": s_adds},
    )
    old_table, old_ms = wall_ms(old_scan, dev)
    rows[-1].update(
        composition_max_abs_err=max_abs_err(s_table, old_table),
        composition_ms=timer(old_scan, 3) if dev.type == "cuda" else old_ms,
    )
    del old_table
    if dev.type == "cuda":
        rows[-1].update(scan_launch_times(s_rec, s_table))
    del s_rec, s_table
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
    n_check = min(64, n_vec)
    oracle = {}
    w3_out = None
    for m in sorted({n_glv, n_vec}, reverse=True):
        ap = og.pack_points(list(bases[:m]), dev)
        sc_m = sc[:, :m]
        calls, (h1, neg_m, h2) = ladder_calls(ap, sc_m, dev)
        if m == n_glv:
            glv_inputs = (ap, (h1, neg_m, h2))
        if m == n_vec:
            w1_inputs = (ap, sc_m)
        products = {
            "ladder_glv_w3": glv_ladder_products(h1, h2, 3),
            "ladder_glv_w4": glv_ladder_products(h1, h2, 4),
            "ladder_w3": w3_products(sc_m),
            "ladder_w1": w1_products(sc_m),
        }
        for name, (got_fn, want_fn) in calls.items():
            if lanes[name] != m:
                continue
            if name != "ladder_w3":
                variant_cases[name] = (lambda f=got_fn: tuple(f()), 3, "ladders.cu")
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
            if name == "ladder_w3":
                w3_out = got
            host = og.jpoints_to_host(og.JPoints(*(g[:, :n_check] for g in got)))
            oracle[name] = host == [
                G1() * Fr(scalars[i].v * dlog(coef, i) % FR_MOD) for i in range(n_check)
            ]
    # ladder_w3 alone at the two widths of the vector ops and at probe widths
    # between, at every group
    w3_row = next(r for r in rows if r["name"] == "ladder_w3")
    w3_widths = sorted({n_vec_small, n_vec} | {w for w in LADDER_PROBE_WIDTHS if w < n_vec})
    w3_row.update(group=cuda_g1.ladder_group(n_vec),
                  group_sweep=ladder_group_sweep(bases, sc, dev, timer, w3_widths, w3_out))
    # ladder_w1 at the vector ops' widths, probe widths between and about
    # twice the wider one, at every group
    w1_row = next(r for r in rows if r["name"] == "ladder_w1")
    w1_widths = sorted({n_vec_small, n_vec, 2 * n_vec - 1} | {w for w in LADDER_PROBE_WIDTHS if w < n_vec})
    w1_row.update(group=cuda_g1.ladder_w1_group(n_vec),
                  group_sweep=w1_group_sweep(*w1_inputs, dev, timer, w1_widths, plain_out["ladder_w1"]))
    # the GLV ladders alone at the protocol's widths and the table's, at every group
    glv_widths = sorted({n_glv} | {w for w in GLV_PROBE_WIDTHS if w < n_glv})
    for w in (3, 4):
        name = f"ladder_glv_w{w}"
        glv_row = next(r for r in rows if r["name"] == name)
        glv_row.update(group=cuda_g1.ladder_glv_group(n_glv, w),
                       group_sweep=glv_group_sweep(*glv_inputs, w, dev, timer, glv_widths, plain_out[name]))
    if dev.type == "cuda":
        for k in (n_vec, n_vec_small):
            tab_k, sc_k = cuda_g1.ladder_w3_table(og.pack_points(list(bases[:k]), dev)), from_reference(sc[:, :k], dev)
            variant_cases[f"ladder_w3_{k}"] = (lambda t=tab_k, s_=sc_k: tuple(cuda_g1.ladder_w3(t, s_)), 3, "ladders.cu")
        # the GLV ladders at the segmented prover's width, the group the wrapper picks
        k = max(w for w in glv_widths if w <= 8192)
        ap_k, (h1, neg_k, h2) = glv_inputs
        args_k = (og.APoints(ap_k.x[:, :k].contiguous(), ap_k.y[:, :k].contiguous(), ap_k.inf[:k].contiguous()),
                  *(from_reference(np.ascontiguousarray(h[..., :k]), dev) for h in (h1, neg_k, h2)))
        for w in (3, 4):
            variant_cases[f"ladder_glv_w{w}_{k}"] = (
                lambda w=w: tuple(cuda_g1.scalar_mul_glv(*args_k, w=w)), 3, "ladders.cu")
    # the three field kernels: decompress at the batched verifier's tracker
    # batch with the edge lanes added, compress on its output, glv_records at
    # n points with identity lanes and the main path's mixed neg1 (the
    # plain chain and the kernel also in turns)
    x_t, s_t, _ = ocompress.parse_encodings(decode_encs)
    x_e, s_e = field_edge_lanes()
    x_dec = from_reference(np.concatenate([x_t, x_e], axis=1), dev)
    s_dec = from_reference(np.concatenate([s_t, s_e]), dev)
    m_dec = x_dec.shape[1]
    # the least work a lane: the cheapest sliding-window root, then to_mont,
    # x^2, x^3, y^2 and from_mont
    dec_squares, dec_products = sqrt_chain_cost()
    dec_squares, dec_products = dec_squares + 2, dec_products + 3
    dec = row(
        "decompress",
        "curdleproofs_tpu/ops/compress.py:33",
        lambda: ocompress._decompress_device(x_dec, s_dec),
        lambda: ocompress._decompress_plain(x_dec, s_dec),
        ops=m_dec * (dec_squares * MULS_PER_SQR + dec_products * MULS_PER_MONT),
        nbytes=m_dec * (4 * 24 + 1 + 4 * 48 + 1),
        source=FIELD_CU,
        shape={"lanes": m_dec, "tracker_points": x_t.shape[1], "edge_lanes": x_e.shape[1],
               "montgomery_squares_a_lane": dec_squares, "montgomery_products_a_lane": dec_products},
    )
    if dev.type == "cuda":
        rows[-1]["graph_ms"] = graph_ms(lambda: ocompress._decompress_device(x_dec, s_dec), 5)
    dec_pts = og.APoints(dec[0], dec[1], torch.zeros(m_dec, dtype=torch.bool, device=dev))
    row(
        "compress",
        "curdleproofs_tpu/ops/compress.py:101",
        lambda: ocompress._compress_device(dec_pts),
        lambda: ocompress._compress_plain(dec_pts),
        ops=m_dec * 2 * MULS_PER_MONT,
        nbytes=m_dec * (4 * 48 + 4 * 24 + 1),
        source=FIELD_CU,
        shape={"lanes": m_dec},
    )
    rec_pts = with_identity_lanes(pts, [0, 1, n // 2, n - 1])
    rec_args = (rec_pts.x, rec_pts.y, rec_pts.inf, from_reference(neg1, dev))
    row(
        "glv_records",
        "curdleproofs_tpu/ops/msm.py:384",
        lambda: omsm._glv_stream_packed(*rec_args),
        lambda: omsm._glv_stream_packed_plain(*rec_args),
        ops=n * MULS_PER_MONT,
        nbytes=n * (4 * 48 + 2 + 4 * 2 * 49),
        source=FIELD_CU,
        shape={"points": n, "identity_lanes": 4, "neg1_lanes": int(neg1.sum())},
    )
    if dev.type == "cuda":
        # both launches are shorter than their wrappers' Python: device time
        # by CUDA graph beside the events' ms
        rows[-2]["graph_ms"] = graph_ms(lambda: ocompress._compress_device(dec_pts), 20)
        rows[-1]["graph_ms"] = graph_ms(lambda: omsm._glv_stream_packed(*rec_args), 20)
        # the fixed cost of one launch: an empty kernel by CUDA graph
        floor = graph_ms(cuda_g1.launch_floor, 20)
        for r in rows[-3:]:
            r["launch_floor_ms"] = floor
        rows[-1]["kernel_and_plain_in_turns_ms"] = in_turns(
            {"kernel": lambda: omsm._glv_stream_packed(*rec_args),
             "plain": lambda: omsm._glv_stream_packed_plain(*rec_args)}, REPS, lambda fn: cuda_ms(fn, 3))
    # the guard: PyTorch ops on CUDA tensors of one call of each entry
    guard = count_cuda_ops({
        "_glv_stream_packed": lambda: omsm._glv_stream_packed(pts.x, pts.y, pts.inf, from_reference(neg1, dev)),
        "batch_decompress": lambda: ocompress.batch_decompress(decode_encs, dev),
    })
    emit(
        {
            "phase": "kernel_times",
            "ladder_oracle_check_lanes": n_check,
            "ladder_oracle_check": oracle,
            "cuda_ops_per_call": guard,
            "cuda_ops_limit": GUARD_MAX_OPS,
        }
    )
    emit({"kernels": rows})
    if dev.type == "cuda":
        over = {k: v["ops"] for k, v in guard.items() if v["ops"] > GUARD_MAX_OPS}
        if over:
            fail(f"more PyTorch ops on CUDA tensors than uploads and allocations: {over}")
    pt_sweep = next(r for r in rows if r["name"] == "point_op")["group_sweep"]
    group_bad = [f"point_op[{b}, m={w['m']}, G={g}]" for w in pt_sweep["widths"]
                 for b, v in w["bodies"].items() for g, ok in v["equal_by_group"].items() if not ok]
    group_bad += [f"{r['name']}[{m}, G={g}]" for r in rows
                  if r["name"] in ("ladder_w3", "ladder_glv_w3", "ladder_glv_w4", "ladder_w1")
                  for m, v in r["group_sweep"].items() for g, ok in v["equal_by_group"].items() if not ok]
    if group_bad:
        fail(f"thread groups disagree with the plain versions: {group_bad}")
    if dev.type == "cuda" and not (pt_sweep["per_msm"]["launches"] and pt_sweep[f"per_scale_points_{n_vec}"]["launches"]):
        fail("the point_op sweep found no launch of msm() or scale_points to time")
    sweep_bad = [k for k, v in sweep.items() if not v["totals_sample_equal"]]
    if sweep_bad:
        fail(f"scan_sel at splits {sweep_bad} disagrees with the default split as points")
    sweep_bad = [k for k, v in full_sweep.items() if v["max_abs_err"] != 0]
    if sweep_bad:
        fail(f"scan_full at splits {sweep_bad} disagrees with its plain version")
    if not all(oracle.values()):
        fail(f"ladders disagree with the discrete-log oracle at the main path's shapes: {oracle}")
    bad = [r["name"] for r in rows if r["max_abs_err"] != 0]
    bad += [f"{r['name']}[against lift, inclusive_scan, cat]" for r in rows if r.get("composition_max_abs_err")]
    bad += [f"gather_u32[{k}]" for k, v in stitch.items() if v["max_abs_err"] != 0]
    bad += [f"gather_u32[n={k}]" for k, v in layout_probe.items() if v["max_abs_err"] != 0]
    if bad:
        fail(f"kernels disagree with their plain versions at the main path's shapes: {bad}")
    if dev.type == "cuda":
        idle = [r["name"] for r in rows if r["launches"] == 0]
        if idle:
            fail(f"the main path never launched: {idle}")
    if variants:
        emit(product_variants(variant_cases))


def phase_group_ab(bases, scalars, coef, dev, n_vec, n_vec_small, n_glv, seg):
    """The thread groups the wrappers pick against one thread a lane on the
    same card, in turns (picked, one, one, picked, twice over): the device
    span and the wall of msm() at n (its 23 point_op launches); for the two
    vector widths the device ms of og.scalar_mul on packed inputs (six
    point_op launches and one ladder_w3, CUDA events) and the wall of
    scale_points; msm() through the GLV ladder at n_glv points (device span
    and wall) and msm_ladder_segmented on seg = (K, m) packed inputs (device
    span and wall), each with one GLV ladder launch."""
    import contextlib

    @contextlib.contextmanager
    def one_thread_a_lane():
        saved = cuda_g1.point_group, cuda_g1.ladder_group, cuda_g1.ladder_glv_group
        cuda_g1.point_group = lambda m, body="jadd": 1
        cuda_g1.ladder_group = lambda m: 1
        cuda_g1.ladder_glv_group = lambda m, w: 1
        try:
            yield
        finally:
            cuda_g1.point_group, cuda_g1.ladder_group, cuda_g1.ladder_glv_group = saved

    want = dlog_expect(coef, scalars)
    want_glv = dlog_expect(coef, scalars[:n_glv])
    K, m = seg
    seg_pts = og.pack_points(list(bases[: K * m]), dev)
    seg_sc = np.asarray(ints_to_limbs([s.v for s in scalars[: K * m]], 16), dtype=np.uint32)
    want_seg = [dlog_expect(coef, scalars[k * m : (k + 1) * m], start=k * m) for k in range(K)]
    packed = {k: (og.pack_points(list(bases[:k]), dev), og.pack_scalars(list(scalars[:k]), dev)) for k in (n_vec, n_vec_small)}
    order = ("picked", "one", "one", "picked") * 2
    keys = ["msm_device_s", "msm_wall_s"] + [f"{what}_{k}" for k in (n_vec, n_vec_small) for what in ("scalar_mul_ms", "scale_points_wall_s")]
    keys += [f"msm_ladder_{n_glv}_device_s", f"msm_ladder_{n_glv}_wall_s", "segmented_device_s", "segmented_wall_s"]
    res = {k: {"picked": [], "one": []} for k in keys}
    ok = True
    for mode in order:
        with one_thread_a_lane() if mode == "one" else contextlib.nullcontext():
            metrics().reset()
            t0 = time.perf_counter()
            ok = ok and msm(bases, scalars, device=dev) == want
            res["msm_wall_s"][mode].append(time.perf_counter() - t0)
            res["msm_device_s"][mode].append(metrics().report()["msm.stream.device"]["total_time_s"])
            for k, (ap, sc_d) in packed.items():
                res[f"scalar_mul_ms_{k}"][mode].append(cuda_ms(lambda: og.scalar_mul(ap, sc_d), 3))
                res[f"scale_points_wall_s_{k}"][mode].append(
                    wall_ms(lambda: ovec.scale_points(bases[:k], scalars[:k], device=dev), dev)[1] / 1e3
                )
            metrics().reset()
            t0 = time.perf_counter()
            ok = ok and msm(bases[:n_glv], scalars[:n_glv], device=dev) == want_glv
            res[f"msm_ladder_{n_glv}_wall_s"][mode].append(time.perf_counter() - t0)
            got, ms = wall_ms(lambda: omsm.msm_ladder_segmented(seg_pts, seg_sc, K), dev)
            ok = ok and got == want_seg
            res["segmented_wall_s"][mode].append(ms / 1e3)
            rep = metrics().report()
            res[f"msm_ladder_{n_glv}_device_s"][mode].append(rep["msm.ladder.device"]["total_time_s"])
            res["segmented_device_s"][mode].append(rep["msm.ladder_seg.device"]["total_time_s"])
    out = {"phase": "group_ab", "order": list(order), "results_ok": ok,
           "glv_group_picked": {f"w{w}": {"msm_ladder": cuda_g1.ladder_glv_group(n_glv, w),
                                          "segmented": cuda_g1.ladder_glv_group(K * m, w)} for w in (3, 4)}}
    for k, v in res.items():
        out[k] = dict(v, median_picked=float(np.median(v["picked"])), median_one=float(np.median(v["one"])))
    emit(out)
    if not ok:
        fail("an MSM with the picked groups or with one thread a lane disagrees with the oracle")


# Build-time variants, timed by --product-variants beside the default build,
# "by_value" (the field arithmetic on carry chains, the product and the
# square out of line with their operands by value): name -> (nvcc flags, the
# sources built with them). cios64 is the arithmetic that came before the
# carry chains (64-bit accumulation, a word-serial product), built for all
# three sources (gather.cu includes no field arithmetic, so its two builds
# are the same code: their difference is the spread of identical builds);
# by_reference and inlined change how fq_mul and fq_sqr are called;
# scan_caps_flipped gives each scan the other's register cap (scan_sel
# uncapped, scan_full capped at 128).
PRODUCT_VARIANTS = {
    "by_value": ((), ("kernels.cu", "ladders.cu", "gather.cu")),
    "cios64": (("-DCURDLE_FQ_CIOS64",), ("kernels.cu", "ladders.cu", "gather.cu")),
    "by_reference": (("-DCURDLE_FQ_MUL_BY_REF",), ("kernels.cu", "ladders.cu")),
    "inlined": (("-DCURDLE_FQ_MUL_INLINE",), ("kernels.cu", "ladders.cu")),
    "scan_caps_flipped": (("-DCURDLE_SCAN_MIN_BLOCKS=1", "-DCURDLE_SCAN_FULL_MIN_BLOCKS=2"), ("kernels.cu",)),
}
VARIANT_BUILD_LIMIT_S = 300
# One call of fq_mul or fq_sqr in a kernel of its own, to count the
# machine instructions of the product and the square under each variant.
PRODUCT_PROBE = """#include "fq.cuh"
using namespace curdle;
#if defined(PROBE_MUL)
extern "C" __global__ void probe(Fq* v) { v[0] = fq_mul(v[1], v[2]); }
#else
extern "C" __global__ void probe(Fq* v) { v[0] = fq_sqr(v[1]); }
#endif
"""
VARIANT_ROUNDS = 3  # rounds of turns, the builds in reverse order every other round


def demangle(names) -> dict:
    """Mangled C++ name -> its readable form up to the argument list
    (`curdle::point_kernel<0, 4>`), by the CUDA toolkit's cu++filt or the
    host's c++filt; the mangled name where neither is found."""
    import os
    import shutil

    names = list(names)
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cu++filt")
    tool = shutil.which("cu++filt") or (toolkit if os.path.exists(toolkit) else None) or shutil.which("c++filt")
    if not names or tool is None:
        return {n: n for n in names}
    out = subprocess.run([tool], input="".join(n + "\n" for n in names), capture_output=True, text=True).stdout.splitlines()
    if len(out) != len(names):
        return {n: n for n in names}

    def head(sig):  # the name up to its argument list; template arguments may hold "(int)"
        depth = 0
        for i, ch in enumerate(sig):
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0:
                return sig[:i]
        return sig

    return {n: head(o).removeprefix("void ").replace("(int)", "") for n, o in zip(names, out)}


def ptxas_stats(stderr: str) -> dict:
    """Kernel -> what ptxas -v said of it: registers, stack frame (local
    memory), spills; one entry per template instantiation, by its readable
    name."""
    entry, stats = None, {}
    for line in stderr.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "stack frame" in line and entry not in stats:
            stats[entry] = {"frame": line.strip()}
        elif entry and "Used" in line and "registers" in line:
            stats[entry]["used"] = line.split(":", 1)[1].strip()
    readable = demangle(stats)
    return {readable[k]: v for k, v in stats.items()}


def product_variants(cases) -> dict:
    """Build the sources of each PRODUCT_VARIANTS entry with its flags, all
    compilers started together, and time each of `cases` (name -> (call
    through the package's wrappers, launches to average, the unit of its
    kernel)) under every build of its unit that compiled, bound in place of
    the loaded one, in VARIANT_ROUNDS rounds of turns. Each variant's outputs
    must equal the loaded build's bit for bit. Each build also reports the
    machine instructions of its kernels, and each variant those of one call
    of fq_mul and of fq_sqr in a kernel of its own (`PRODUCT_PROBE`, with
    the call's loads and stores)."""
    import ctypes
    import tempfile
    import types

    report = {"phase": "product_variants", "builds_side_by_side": sum(len(u) for _, u in PRODUCT_VARIANTS.values())}
    with tempfile.TemporaryDirectory() as tmp:
        running = {}
        t0 = time.perf_counter()
        probe = f"{tmp}/probe.cu"
        with open(probe, "w") as fh:
            fh.write(PRODUCT_PROBE)
        probes = {}
        for v, (flags, units) in PRODUCT_VARIANTS.items():
            for unit in units:
                so, log = f"{tmp}/{v}_{unit}.so", open(f"{tmp}/{v}_{unit}.log", "w+")
                cmd = cuda_g1.nvcc_command(unit, so, extra=(*flags, "-Xptxas", "-v"))
                running[(v, unit)] = (so, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
            for name in ("mul", "sqr"):
                so = f"{tmp}/{v}_probe_{name}.so"
                cmd = cuda_g1.nvcc_command(probe, so, extra=(*flags, f"-DPROBE_{name.upper()}"))  # an absolute path
                probes[(v, name)] = (so, subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        builds = {v: {"flags": list(f), "units": {}} for v, (f, _) in PRODUCT_VARIANTS.items()}
        while any(p.poll() is None for _, _, p in running.values()):
            if time.perf_counter() - t0 > VARIANT_BUILD_LIMIT_S:
                break
            time.sleep(0.25)
            for (v, unit), (_so, _log, p) in running.items():
                if p.poll() is not None and unit not in builds[v]["units"]:
                    builds[v]["units"][unit] = {"nvcc_s": time.perf_counter() - t0}
        for (v, unit), (so, log, p) in running.items():
            if p.poll() is None:
                p.kill()
                p.wait()
                builds[v]["units"][unit] = {"error": f"no library after {VARIANT_BUILD_LIMIT_S} s"}
            else:
                log.seek(0)
                text = log.read()
                entry = builds[v]["units"].setdefault(unit, {"nvcc_s": time.perf_counter() - t0})
                if p.returncode:
                    entry["error"] = f"nvcc exit {p.returncode}: {text[-2000:]}"
                else:
                    entry["ptxas"] = ptxas_stats(text)
                    entry["sass_instructions"] = {k: v["instructions"] for k, v in sass_counts(so).items()}
                    entry["so"] = so
            log.close()
        for (v, name), (so, p) in probes.items():
            if p.wait() == 0:
                builds[v].setdefault("sass_probe", {})[f"fq_{name}"] = sum(
                    c["instructions"] for c in sass_counts(so).values())
        loaded = cuda_g1.lib()
        bound = {}  # variant -> its bindings and the units that built
        for v, b in builds.items():
            ns, built = types.SimpleNamespace(**vars(loaded)), set()
            for unit, u in b["units"].items():
                if "so" not in u:
                    continue
                lib_ = ctypes.CDLL(u.pop("so"))
                for name, argtypes in cuda_g1.ENTRY_POINTS[unit].items():
                    fn = getattr(lib_, name)
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    setattr(ns, name, fn)
                built.add(unit)
            bound[v] = (ns, built)
        ms = {v: {c: [] for c, case in cases.items() if case[2] in built} for v, (_, built) in bound.items()}
        err = {v: {} for v in bound}
        want = {c: list(fn()) for c, (fn, _, _) in cases.items()}  # every case returns a tuple
        try:
            for rnd in range(VARIANT_ROUNDS):
                for v, (ns, _) in (bound.items() if rnd % 2 == 0 else reversed(bound.items())):
                    cuda_g1._lib = ns
                    for c in ms[v]:
                        fn, iters, _ = cases[c]
                        if rnd == 0:
                            err[v][c] = max_abs_err(list(fn()), want[c])
                        ms[v][c].append(cuda_ms(fn, iters))
        finally:
            cuda_g1._lib = loaded
    for v, b in builds.items():
        b["ms"] = ms[v]
        b["max_abs_err_vs_loaded_build"] = err[v]
    report["variants"] = builds
    report["seconds"] = time.perf_counter() - t0
    bad = [v for v, e in err.items() if any(e.values())]
    if bad:
        fail(f"product variants {bad} disagree with the loaded build")
    return report


def sass_counts(so: str) -> dict:
    """Machine instructions of each function (kernels and the out-of-line
    fq_mul / fq_sqr) in a built library, by the CUDA toolkit's cuobjdump:
    readable name -> {"instructions": n, "top": the eight most frequent
    opcodes}. Empty where cuobjdump is not found."""
    import os
    import re
    import shutil
    from collections import Counter

    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = shutil.which("cuobjdump") or (toolkit if os.path.exists(toolkit) else None)
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True).stdout
    ops, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            ops[fn] = Counter()
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and ins:
            ops[fn][ins.group(1)] += 1
    readable = demangle(ops)
    return {readable[k]: {"instructions": sum(c.values()), "top": dict(c.most_common(8))} for k, c in ops.items()}


def ptxas_report() -> int:
    """What ptxas says of each kernel (registers, stack frame in local memory,
    spills) and the machine instructions of each function. Needs nvcc, no
    card."""
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
            emit({"phase": "ptxas", "source": unit, "nvcc_s": seconds, "kernels": ptxas_stats(proc.stderr),
                  "sass": sass_counts(f"{tmp}/out.so")})
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
    ap.add_argument(
        "--product-variants",
        action="store_true",
        help="after kernel_times, build and time the product's variants (csrc/fq.cuh) and the scans' register caps",
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
        omsm.ROUTE_MIN_FACTOR = 8
        n_main, n_redo, n_sort = 128, 128, 20
        n_ladder, small_sizes, seg, m_edge = 63, (17, 20), (4, 4), 20
        n_vec_small, n_vec_big, n_sample = 6, 12, 4
        ell, k_proofs = 4, 4
        # the batched verifier's merged MSM (about 200 bases) on the stream
        # path and its decode (64 points) on the tensor code; one proof's
        # MSMs (at most 70 bases) stay on the host backend; the lockstep
        # merges of 16 lanes and more (4 provers) on the tensor code
        vectors.DEVICE_MIN, hcurve.DECOMPRESS_DEVICE_MIN = 128, 32
        lockstep_min = 16
        # the spawned ranks' SEL_MIN_N and scan lanes: 32 points a rank
        # take the sel path there
        ranks4_knobs = (64, 16)
        REPS = 1
        gpu_line = "cpu rehearsal"
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        dev = torch.device("cuda")
        n_main, n_redo, n_sort = 1 << 16, 1 << 14, 1 << 12
        n_ladder, small_sizes, seg, m_edge = omsm.STREAM_MIN - 1, (17, 124, 4096), (64, 128), 256
        n_vec_small, n_vec_big, n_sample = 124, 8192, 256
        ell, k_proofs = 124, 64  # the Whisk spec's ell; a batch of 64 shuffles
        lockstep_min = vectors.DEVICE_MIN
        ranks4_knobs = (omsm.SEL_MIN_N, ostream._LANES)
        gpu_line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        t0 = time.perf_counter()
        cuda_g1.lib()
        load_s = time.perf_counter() - t0
        if not host_native.available():
            fail("no C compiler: the native host library cannot be built")
        host_native.lib()
        emit(
            {
                "phase": "device",
                "gpu": gpu_line,
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "build_s": cuda_g1.build_seconds,
                "load_s": load_s,
                "host_native": {
                    "cc": host_native.built_with,
                    "build_s": host_native.build_seconds,
                    "openmp_threads": host_native.openmp_threads(),
                },
            }
        )
    n_split = n_main + n_main // 2 + 5

    coef = tuple(rand_scalar(rng) for _ in range(3))
    t0 = time.perf_counter()
    bases = progression_bases(*coef, n_split)
    scalars = [Fr(rand_scalar(rng)) for _ in range(n_split)]
    emit({"phase": "inputs", "n": n_split, "seed": args.seed, "seconds": time.perf_counter() - t0})

    n2_main = 2 * n_main
    route_shape = (*oroute.pick_rc(n2_main, omsm.ROUTE_MIN_FACTOR), -(-130 // omsm.pick_window(n_main)))
    timed_phase("kernels", phase_kernels, bases, dev, rng, m_edge, route_shape)
    timed_phase("host_native", phase_host_native, scalars[:n_main], dev)

    # the main paths: each sets the launch counts to 0 just before it drives
    # its entry points and returns them as read just after
    point_widths = {}  # path -> (body, m) -> point_op launches, from those runs
    by_phase = {
        "msm_2e16": timed_phase("msm_2e16", phase_msm_main, bases[:n_main], scalars[:n_main], coef, dev, point_widths),
        "msm_redo": timed_phase("msm_redo", phase_msm_redo, n_redo, dev),
        "msm_split": timed_phase("msm_split", phase_msm_split, bases, scalars, coef, dev),
        "msm_routed": timed_phase(
            "msm_routed", phase_msm_routed, bases[:n_main], scalars[:n_main], coef, dev
        ),
        "msm_sort": timed_phase("msm_sort", phase_msm_sort, bases[:n_sort], scalars[:n_sort], coef, dev),
        "msm_ladder": timed_phase(
            "msm_ladder", phase_msm_ladder, bases[:n_ladder], scalars[:n_ladder], coef, dev, small_sizes
        ),
        "ladder_segmented": timed_phase(
            "ladder_segmented", phase_ladder_segmented, bases, scalars, coef, dev, *seg
        ),
        "vector_ops": timed_phase(
            "vector_ops", phase_vector_ops, bases, scalars, coef, dev, n_vec_small, n_vec_big, n_sample, rng,
            point_widths,
        ),
        "entry": timed_phase("entry", phase_entry, dev),
    }
    # the Whisk protocol through its entry points: one proof, K proofs
    # verified in one batch, their tracker decode, K proofs in lockstep
    prng = ProofRng(args.seed)
    crs = P.CurdleproofsCrs.new(ell, P.N_BLINDERS, prng)
    pres = [_trackers(prng, ell) for _ in range(k_proofs)]
    proofs = {}
    by_phase["whisk_single"] = timed_phase("whisk_single", phase_whisk_single, crs, pres[0], dev, args.seed + 1)
    by_phase["whisk_batch_verify"] = timed_phase(
        "whisk_batch_verify", phase_whisk_batch_verify, crs, pres, dev, args.seed + 2, proofs
    )
    by_phase["decompress"], decode_encs = timed_phase("decompress", phase_decompress, pres, proofs, dev)
    by_phase["whisk_lockstep_prove"] = timed_phase(
        "whisk_lockstep_prove", phase_whisk_lockstep_prove, crs, pres, dev, args.seed + 2, proofs, lockstep_min
    )
    # the sharded MSM (parallel/): a world of one process on the card (NCCL),
    # then four processes sharing the card (gloo)
    by_phase["sharded_world1"] = timed_phase(
        "sharded_world1", phase_sharded_world1, bases[:n_main], scalars[:n_main], coef, dev, n_ladder, n_sort
    )
    by_phase["sharded_ranks4"] = timed_phase(
        "sharded_ranks4", phase_sharded_ranks4, bases[:n_main], scalars[:n_main], coef, dev, n_ladder, n_sort,
        ranks4_knobs,
    )
    launches = {k: sum(c[k] for c in by_phase.values()) for k in cuda_g1.KERNEL_NAMES}

    timed_phase(
        "kernel_times", phase_kernel_times, bases[:n_main], scalars[:n_main], dev, launches, by_phase,
        n_ladder, n_vec_big, n_vec_small, coef, point_widths, decode_encs,
        args.product_variants and dev.type == "cuda",
    )
    if dev.type == "cuda":
        timed_phase("group_ab", phase_group_ab, bases[:n_main], scalars[:n_main], coef, dev, n_vec_big, n_vec_small,
                    small_sizes[-1], seg)
    timed_phase("trace_msm", phase_trace_msm, bases[:n_main], scalars[:n_main], coef, dev)
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
