"""The CUDA side of the package: build, binding, launch counts, and the
wrappers of the elementwise point kernel and of the scalar-multiplication
ladders.

Counterpart of the JAX package's `ops.pallas_g1` (`_build_kernel` with its
`jadd` / `jdbl` / `jmadd` wrappers, and `scalar_mul_glv`, `scalar_mul`,
`scalar_mul_w1` over `_build_glv_ladder_kernel`, `_build_glv_ladder_w4_kernel`,
`_build_ladder_w3_kernel`, `_build_ladder_kernel`), and home of the wrappers
of the three field programs that the JAX package jits (`decompress`,
`compress`, `glv_records`: `ops.compress`, `ops.msm`). The kernels are
hand-written CUDA C++ for sm_90a under ../csrc (`fq.cuh`, `g1.cuh`;
`kernels.cu`, `ladders.cu`, `gather.cu` and `field_kernels.cu`, plain C
interfaces). Each `.cu` is compiled
with `nvcc` at first use into a shared library of its own under `build/`
inside the package directory, both compilers started together, and loaded
with `ctypes`; nothing is built or imported from CUDA when this module is
imported.

`point_op` and the ladders are bound by operations, not bytes: a complete
Jacobian add is 16 Montgomery products (300 32-bit multiplies each) on 6
field elements read and 3 written, and a ladder chains 2,300 to 4,600 such
products per lane between reading a point and writing one. In `point_op` and
in every ladder a group of `group` threads (1, 2 or 4, `GROUPS`) serves a
lane and runs each formula's independent products side by side
(csrc/g1.cuh); `point_group(m, body)`, `ladder_group(m)`,
`ladder_w1_group(m)` and `ladder_glv_group(m, w)` pick it from the width, and
the wrappers compute the grid (`launch_blocks`).

Every wrapper launches on `torch.cuda.current_stream()`, allocates its outputs
with `torch.empty` (`point_strided`, one step of the prefix scan's level
schedule, writes into the buffers it is given), raises on a non-zero return,
and adds one to its entry in `launch_counts` where it launches — nowhere
else. There is no fallback: a CUDA tensor goes to the kernel or the call
raises. The plain PyTorch versions of the ladders stand in `ops.g1`, whose
`scalar_mul*` functions hand CPU tensors to them and CUDA tensors to the
wrappers here.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from curdleproofs_tpu_torch.ops.fieldspec import FQ_SPEC
from curdleproofs_tpu_torch.ops.glv import BETA as _GLV_BETA

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
HEADERS = ("fq.cuh", "g1.cuh")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# source -> its C entry points and their argument types (all return int)
ENTRY_POINTS = {
    "kernels.cu": {
        "curdle_scan_sel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "curdle_scan_full": [_P, _P, _P, _I, _I, _I, _I, _P],
        "curdle_gather_u32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "curdle_point_op": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "curdle_point_strided": [_P, _I, _I, _I, _I, _I, _P],
    },
    "ladders.cu": {
        "curdle_ladder_glv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "curdle_ladder_w3": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "curdle_ladder_w1": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "gather.cu": {
        "curdle_rowwise_gather": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "field_kernels.cu": {
        "curdle_decompress": [_P, _P, _P, _P, _P, _I, _P],
        "curdle_compress": [_P, _P, _P, _P, _I, _P],
        "curdle_glv_records": [_P, _P, _P, _P, _P, _I, _P],
        "curdle_launch_floor": [_P],
    },
}

KERNEL_NAMES = (
    "scan_sel",
    "scan_full",
    "gather_u32",
    "point_op",
    "point_strided",
    "ladder_glv_w3",
    "ladder_glv_w4",
    "ladder_w3",
    "ladder_w1",
    "rowwise_gather",
    "decompress",
    "compress",
    "glv_records",
)

# launches per kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {k: 0 for k in KERNEL_NAMES}

# GLV ladder window width, 3 or 4: 43 iterations over 7-entry tables or 33
# over 15-entry tables. The JAX package's knob, under its name.
GLV_W = int(os.environ.get("CURDLEPROOFS_GLV_W", "3"))

# Threads a lane that the point kernel (csrc/kernels.cu) and the ladders
# (csrc/ladders.cu) are built for, and their block widths there.
GROUPS = (1, 2, 4)
POINT_THREADS = 128
LADDER_THREADS = 32

_lock = threading.Lock()
_lib: Optional[types.SimpleNamespace] = None
build_seconds: Optional[float] = None  # nvcc wall time of this process's build


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _beta_mont_limbs() -> np.ndarray:
    """The GLV endomorphism constant beta in Montgomery form, (24,) limbs."""
    v = _GLV_BETA * FQ_SPEC.r_mod % FQ_SPEC.modulus
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(24)], dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _beta_words():
    """beta as the 12 host words the GLV ladder's C entry point reads."""
    limbs = _beta_mont_limbs()
    return (ctypes.c_uint32 * 12)(*(int(limbs[2 * k]) | int(limbs[2 * k + 1]) << 16 for k in range(12)))


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(unit: str) -> Path:
    """Where the shared library of one `.cu` lies. The file name carries a
    hash of that source, the headers and the flags, so an edit never loads a
    stale build."""
    h = hashlib.sha256()
    for name in HEADERS + (unit,):
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcurdle_{Path(unit).stem}_{h.hexdigest()[:16]}.so"


def nvcc_command(unit: str, out: Path, extra=()) -> list:
    return [_find_nvcc(), *NVCC_FLAGS, *extra, "-I", str(CSRC_DIR), "-o", str(out), str(CSRC_DIR / unit)]


def lib() -> types.SimpleNamespace:
    """The kernels' C entry points, bound and ready to call. At first use
    every source without a library is compiled, one `nvcc` each, all started
    together. Threads that make their first launch at once wait on one lock:
    one of them builds, and all get the same bindings."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:  # else another thread built it meanwhile
            _lib = _build_and_bind()
        return _lib


def _build_and_bind() -> types.SimpleNamespace:
    global build_seconds
    paths = {unit: library_path(unit) for unit in ENTRY_POINTS}
    running = []
    t0 = time.perf_counter()
    for unit, so in paths.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # process and thread in the name: a build of another process never
        # shares the temporary file
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = nvcc_command(unit, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((so, tmp, cmd, proc))
    failures = []
    for so, tmp, cmd, proc in running:  # wait for every compiler before raising
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))
    if running:
        build_seconds = time.perf_counter() - t0
    bound = types.SimpleNamespace()
    for unit, so in paths.items():
        loaded = ctypes.CDLL(str(so))
        for name, argtypes in ENTRY_POINTS[unit].items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(bound, name, fn)
    return bound


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_tensor(name: str, t: torch.Tensor, shape, dtype=torch.int32) -> None:
    """What every kernel requires of an argument: CUDA, dtype, shape,
    contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {rc})")


# ---------------------------------------------------------------------------
# thread groups
# ---------------------------------------------------------------------------


# Thread groups by width, from chip_smoke.py's group sweeps of point_op,
# ladder_w3 and the GLV ladders on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md). A group shortens a lane's chain of dependent products and
# multiplies the warps, at the price of more work a lane: up to 1.5x the
# products (a thread with no product of its own in a round repeats one), the
# additions every thread redoes, and the shuffles that swap the products. So
# it pays while the lanes' warps leave the card's 528 schedulers short of
# work: G = 4 up to about one warp a scheduler, G = 2 for the GLV ladders up
# to about two.
# point_op: body -> (widest m for G = 4, widest m for G = 2); G = 1 beyond.
POINT_GROUP_LIMITS = {"jadd": (8192, 16384), "jdbl": (2560, 8192), "jmadd": (2560, 16384)}
# ladder_w3: (widest m for G = 4, widest m for G = 2); G = 1 beyond (G = 2
# past 8,192 lanes is not measured).
LADDER_GROUP_LIMITS = (8192, 8192)
# ladder_w1, the same: its add is one mixed add of the base, so a step holds
# fewer products than ladder_w3's and G = 2 overtakes G = 4 sooner. At 6,144
# and 8,192 lanes G = 2 ran 3.15 / 3.14 ms against G = 4's 3.22 / 3.24, at
# 16,383 4.24 against G = 1's 5.02 and G = 4's 6.47 (chip_smoke.py
# `group_sweep` on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
LADDER_W1_GROUP_LIMITS = (4096, 16384)
# the GLV ladders: window width -> (widest m for G = 4, widest m for G = 2).
GLV_GROUP_LIMITS = {3: (8192, 16384), 4: (8192, 16384)}


def point_group(m: int, body: str = "jadd") -> int:
    """Threads a lane for `point_op` of `body` at m lanes."""
    four, two = POINT_GROUP_LIMITS[body]
    return 4 if m <= four else 2 if m <= two else 1


def ladder_group(m: int) -> int:
    """Threads a lane for `ladder_w3` at m lanes."""
    four, two = LADDER_GROUP_LIMITS
    return 4 if m <= four else 2 if m <= two else 1


def ladder_w1_group(m: int) -> int:
    """Threads a lane for `ladder_w1` at m lanes."""
    four, two = LADDER_W1_GROUP_LIMITS
    return 4 if m <= four else 2 if m <= two else 1


def ladder_glv_group(m: int, w: int) -> int:
    """Threads a lane for the GLV ladder of window width w at m lanes."""
    four, two = GLV_GROUP_LIMITS[w]
    return 4 if m <= four else 2 if m <= two else 1


def check_group(name: str, group: int) -> None:
    if group not in GROUPS:
        raise ValueError(f"{name}: group must be one of {GROUPS} (the kernels built), got {group}")


def launch_blocks(m: int, group: int, threads: int) -> int:
    """Blocks of `threads` that give each of m lanes its `group` threads.
    Thread t of the grid serves lane t // group as thread t % group of its
    group; the threads past m * group compute the last lane again and
    store nothing."""
    return -(-m * group // threads)


# ---------------------------------------------------------------------------
# point_op
# ---------------------------------------------------------------------------

_BODIES = {"jadd": 0, "jdbl": 1, "jmadd": 2}


def point_op(body: str, coords, qinf: Optional[torch.Tensor] = None, group: Optional[int] = None):
    """Launch the elementwise point kernel. coords: 6 (jadd), 3 (jdbl) or 5
    (jmadd) contiguous (24, m) int32 CUDA tensors; qinf (m,) int32 for jmadd;
    group: threads a lane (default `point_group(m, body)`). Returns three (24, m)
    tensors (X, Y, Z)."""
    n_in = {"jadd": 6, "jdbl": 3, "jmadd": 5}[body]
    if len(coords) != n_in:
        raise ValueError(f"{body}: expected {n_in} coordinate tensors")
    m = coords[0].shape[-1]
    group = point_group(m, body) if group is None else group
    check_group(f"point_op[{body}]", group)
    for k, c in enumerate(coords):
        check_tensor(f"{body} input {k}", c, (24, m))
    if body == "jmadd":
        if qinf is None:
            raise ValueError("jmadd: the infinity row is required")
        check_tensor("jmadd inf row", qinf, (m,))
    outs = [torch.empty((24, m), dtype=torch.int32, device=coords[0].device) for _ in range(3)]
    if m == 0:
        return tuple(outs)
    ptrs = [c.data_ptr() for c in coords] + [None] * (6 - n_in)
    with torch.cuda.device(coords[0].device):
        rc = lib().curdle_point_op(
            _BODIES[body],
            *ptrs,
            qinf.data_ptr() if qinf is not None else None,
            *(o.data_ptr() for o in outs),
            m,
            group,
            launch_blocks(m, group, POINT_THREADS),
            stream_ptr(),
        )
    check_launch(f"point_op[{body}]", rc)
    launch_counts["point_op"] += 1
    return tuple(outs)


# the fields of csrc/kernels.cu's PointView, in its order
POINT_VIEW_WORDS = 7


def _view_words(bufs, op, lanes: int):
    """One operand of `point_strided` as the PointView words the C entry
    point reads; raises where a lane it reads or writes falls outside its
    buffer (the kernel cannot check)."""
    if op is None:
        return [0] * POINT_VIEW_WORDS
    t = bufs[op.buf]
    if t.shape[0] not in (49, 72):
        raise ValueError(f"point_strided: a buffer has {t.shape[0]} rows, not 49 or 72")
    if op.lo < lanes and (op.off + op.step * op.lo < 0 or op.off + op.step * (lanes - 1) >= t.shape[-1]):
        raise ValueError(f"point_strided: {op} reaches outside {t.shape[-1]} columns at {lanes} lanes")
    return [t.data_ptr(), t.stride(0), t.stride(1), op.off, op.step, op.lo, int(t.shape[0] == 49)]


def point_strided(bufs, step, group: Optional[int] = None) -> None:
    """One launch of `point_kernel_strided`, one step of
    `ops.scan.scan_schedule`: bufs (records (49, wb, n), scratch and table
    (72, wb, *)) contiguous int32 CUDA tensors, step an `ops.scan.Launch`
    whose operands name them and whose `kind` names the kernel body (the
    library refuses views that do not fit it); group: threads a lane
    (default `point_group(wb * lanes, "jadd")`). Writes in place, returns
    nothing."""
    rows = bufs[0].shape[1]
    m = rows * step.lanes
    group = point_group(m, "jadd") if group is None else group
    check_group("point_strided", group)
    for k, t in enumerate(bufs):
        check_tensor(f"point_strided buffer {k}", t, (t.shape[0], rows, t.shape[-1]))
    for op in (step.out, step.copy_out):
        if op is not None and bufs[op.buf].shape[0] != 72:
            raise ValueError("point_strided: writes go to 72-row tables, never to the records")
    words = []
    for op in (step.p, step.q, step.out, step.copy, step.copy_out):
        words += _view_words(bufs, op, step.lanes)
    views = (ctypes.c_longlong * len(words))(*words)
    with torch.cuda.device(bufs[0].device):
        rc = lib().curdle_point_strided(
            ctypes.cast(views, ctypes.c_void_p), step.kind, step.lanes, rows, group,
            launch_blocks(m, group, POINT_THREADS), stream_ptr(),
        )
    check_launch("point_strided", rc)
    launch_counts["point_strided"] += 1


def _flat(arrs):
    """Broadcast (24, *B) tensors to one shape and flatten to contiguous
    (24, m)."""
    arrs = torch.broadcast_tensors(*arrs)
    shape = arrs[0].shape
    return [a.reshape(24, -1).contiguous() for a in arrs], shape


def jadd(p, q, group: Optional[int] = None):
    """Complete Jacobian + Jacobian add on (24, *B) CUDA coords."""
    from curdleproofs_tpu_torch.ops.g1 import JPoints

    flats, shape = _flat([p.x, p.y, p.z, q.x, q.y, q.z])
    x, y, z = point_op("jadd", flats, group=group)
    return JPoints(x.reshape(shape), y.reshape(shape), z.reshape(shape))


def jdbl(p, group: Optional[int] = None):
    """Jacobian doubling on (24, *B) CUDA coords."""
    from curdleproofs_tpu_torch.ops.g1 import JPoints

    flats, shape = _flat([p.x, p.y, p.z])
    x, y, z = point_op("jdbl", flats, group=group)
    return JPoints(x.reshape(shape), y.reshape(shape), z.reshape(shape))


def jmadd(p, q, group: Optional[int] = None):
    """Complete Jacobian + affine mixed add on (24, *B) CUDA coords."""
    from curdleproofs_tpu_torch.ops.g1 import JPoints

    flats, shape = _flat([p.x, p.y, p.z, q.x, q.y])
    qinf = q.inf.expand(shape[1:]).reshape(-1).to(torch.int32).contiguous()
    x, y, z = point_op("jmadd", flats, qinf, group=group)
    return JPoints(x.reshape(shape), y.reshape(shape), z.reshape(shape))


# ---------------------------------------------------------------------------
# the scalar-multiplication ladders
# ---------------------------------------------------------------------------


def _lane_row(name: str, row: torch.Tensor, m: int, dtype=torch.int32) -> torch.Tensor:
    """A per-lane flag (bool or integer, any batch shape) as the (m,) row the
    kernels read: int32 for the ladders, bool (one byte a lane) for the
    field kernels."""
    flat = row.reshape(-1).to(dtype).contiguous()
    check_tensor(name, flat, (m,), dtype)
    return flat


def _ladder_base(name: str, points):
    """The affine base points of a ladder as checked contiguous (24, m) CUDA
    coords, with the batch shape to restore."""
    (px, py), shape = _flat([points.x, points.y])
    m = px.shape[-1]
    check_tensor(f"{name} x", px, (24, m))
    check_tensor(f"{name} y", py, (24, m))
    return px, py, shape, m


def _ladder_outputs(like: torch.Tensor, m: int):
    return [torch.empty((24, m), dtype=torch.int32, device=like.device) for _ in range(3)]


def scalar_mul_glv(points, s1, neg1, s2, w: Optional[int] = None, group: Optional[int] = None):
    """Launch the GLV dual-table ladder: per lane k*P = k1*P + k2*phi(P).

    points: APoints of (24, *B) CUDA coords; s1, s2: (9, *B) int32 limbs of
    |k1|, k2; neg1: (*B,) sign of k1 (as `ops.glv.decompose` returns them);
    w: window width 3 or 4 (default GLV_W); group: threads a lane (default
    `ladder_glv_group(m, w)`). Returns Jacobian (24, *B)."""
    from curdleproofs_tpu_torch.ops.g1 import JPoints

    w = GLV_W if w is None else w
    if w not in (3, 4):
        raise ValueError(f"scalar_mul_glv: window width must be 3 or 4, got {w}")
    if group is not None:
        check_group("scalar_mul_glv", group)
    px, py, shape, m = _ladder_base("scalar_mul_glv", points)
    group = ladder_glv_group(m, w) if group is None else group
    k1 = s1.reshape(9, -1).contiguous()
    k2 = s2.reshape(9, -1).contiguous()
    check_tensor("scalar_mul_glv s1", k1, (9, m))
    check_tensor("scalar_mul_glv s2", k2, (9, m))
    inf = _lane_row("scalar_mul_glv inf", points.inf, m)
    neg = _lane_row("scalar_mul_glv neg1", neg1, m)
    outs = _ladder_outputs(px, m)
    if m:
        with torch.cuda.device(px.device):
            rc = lib().curdle_ladder_glv(
                w, px.data_ptr(), py.data_ptr(), inf.data_ptr(), neg.data_ptr(),
                k1.data_ptr(), k2.data_ptr(), ctypes.cast(_beta_words(), ctypes.c_void_p),
                *(o.data_ptr() for o in outs), m, group, launch_blocks(m, group, LADDER_THREADS), stream_ptr(),
            )
        check_launch(f"ladder_glv_w{w}", rc)
        launch_counts[f"ladder_glv_w{w}"] += 1
    return JPoints(*(o.reshape(shape) for o in outs))


def ladder_w3_table(base) -> torch.Tensor:
    """The table {1..7}P of `ladder_w3` for affine (24, m) CUDA points, as
    (7, 72, m): six launches of the point kernel (dbl, madd, dbl, madd,
    dbl, madd)."""
    from curdleproofs_tpu_torch.ops.g1 import lift

    t1 = lift(base)
    t2 = jdbl(t1)
    t3 = jmadd(t2, base)
    t4 = jdbl(t2)
    t5 = jmadd(t4, base)
    t6 = jdbl(t3)
    t7 = jmadd(t6, base)
    return torch.stack([torch.cat(tuple(t), dim=0) for t in (t1, t2, t3, t4, t5, t6, t7)])


def ladder_w3(table: torch.Tensor, sc: torch.Tensor, group: Optional[int] = None):
    """One `ladder_w3` launch: table (7, 72, m) from `ladder_w3_table`, sc
    (16, m) canonical Fr limbs; group: threads a lane (default
    `ladder_group(m)`). Returns three (24, m) tensors (X, Y, Z)."""
    m = sc.shape[-1]
    group = ladder_group(m) if group is None else group
    check_group("ladder_w3", group)
    check_tensor("ladder_w3 table", table, (7, 72, m))
    check_tensor("ladder_w3 scalars", sc, (16, m))
    outs = _ladder_outputs(sc, m)
    if m:
        with torch.cuda.device(sc.device):
            rc = lib().curdle_ladder_w3(
                table.data_ptr(), sc.data_ptr(), *(o.data_ptr() for o in outs), m, group,
                launch_blocks(m, group, LADDER_THREADS), stream_ptr(),
            )
        check_launch("ladder_w3", rc)
        launch_counts["ladder_w3"] += 1
    return outs


def scalar_mul(points, scalars, group: Optional[int] = None):
    """Per lane k*P over (16, *B) canonical Fr limbs with the 3-bit windowed
    ladder: the table {1..7}P (`ladder_w3_table`), then one `ladder_w3`
    launch runs the 85 window iterations with `group` threads a lane
    (default `ladder_group(m)`). Returns Jacobian (24, *B)."""
    from curdleproofs_tpu_torch.ops.g1 import APoints, JPoints

    if group is not None:
        check_group("scalar_mul", group)
    px, py, shape, m = _ladder_base("scalar_mul", points)
    sc = scalars.reshape(16, -1).contiguous()
    check_tensor("scalar_mul scalars", sc, (16, m))
    if m:
        table = ladder_w3_table(APoints(px, py, points.inf.reshape(-1)))
        outs = ladder_w3(table, sc, group)
    else:
        outs = _ladder_outputs(px, m)
    return JPoints(*(o.reshape(shape) for o in outs))


def scalar_mul_w1(points, scalars, group: Optional[int] = None):
    """Per lane k*P with the bitwise ladder (255 doublings, a complete mixed
    add per set bit); the cross-check of the windowed ladders. group:
    threads a lane (default `ladder_w1_group(m)`). Returns Jacobian (24, *B)."""
    from curdleproofs_tpu_torch.ops.g1 import JPoints

    if group is not None:
        check_group("scalar_mul_w1", group)
    px, py, shape, m = _ladder_base("scalar_mul_w1", points)
    group = ladder_w1_group(m) if group is None else group
    sc = scalars.reshape(16, -1).contiguous()
    check_tensor("scalar_mul_w1 scalars", sc, (16, m))
    inf = _lane_row("scalar_mul_w1 inf", points.inf, m)
    outs = _ladder_outputs(px, m)
    if m:
        with torch.cuda.device(px.device):
            rc = lib().curdle_ladder_w1(
                px.data_ptr(), py.data_ptr(), inf.data_ptr(), sc.data_ptr(),
                *(o.data_ptr() for o in outs), m, group, launch_blocks(m, group, LADDER_THREADS), stream_ptr(),
            )
        check_launch("ladder_w1", rc)
        launch_counts["ladder_w1"] += 1
    return JPoints(*(o.reshape(shape) for o in outs))


# ---------------------------------------------------------------------------
# the field programs (csrc/field_kernels.cu)
# ---------------------------------------------------------------------------


def decompress(x: torch.Tensor, sign: torch.Tensor):
    """Launch `decompress_kernel`: x (24, n) canonical limbs, sign (n,) the
    lexicographic-largest flags -> xm, ym (24, n) Montgomery and ok (n,)
    bool (the root existed). The kernel of `ops.compress._decompress_device`."""
    x = x.contiguous()
    n = x.shape[-1]
    check_tensor("decompress x", x, (24, n))
    sign = _lane_row("decompress sign", sign, n, torch.bool)
    xm, ym = (torch.empty((24, n), dtype=torch.int32, device=x.device) for _ in range(2))
    ok = torch.empty(n, dtype=torch.bool, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            rc = lib().curdle_decompress(
                x.data_ptr(), sign.data_ptr(), xm.data_ptr(), ym.data_ptr(), ok.data_ptr(), n, stream_ptr()
            )
        check_launch("decompress", rc)
        launch_counts["decompress"] += 1
    return xm, ym, ok


def compress(x: torch.Tensor, y: torch.Tensor):
    """Launch `compress_kernel`: affine x, y (24, n) Montgomery -> x (24, n)
    canonical and largest (n,) bool (canonical y > (p - 1) / 2). The kernel
    of `ops.compress._compress_device`."""
    x, y = x.contiguous(), y.contiguous()
    n = x.shape[-1]
    check_tensor("compress x", x, (24, n))
    check_tensor("compress y", y, (24, n))
    xc = torch.empty((24, n), dtype=torch.int32, device=x.device)
    largest = torch.empty(n, dtype=torch.bool, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            rc = lib().curdle_compress(x.data_ptr(), y.data_ptr(), xc.data_ptr(), largest.data_ptr(), n, stream_ptr())
        check_launch("compress", rc)
        launch_counts["compress"] += 1
    return xc, largest


def glv_records(px: torch.Tensor, py: torch.Tensor, pinf: torch.Tensor, neg1: torch.Tensor) -> torch.Tensor:
    """Launch `glv_records_kernel`: affine px, py (24, n) Montgomery, pinf
    and neg1 (n,) -> the (49, 2n) stream records [px, sgn(neg1) py, inf |
    beta px, py, inf]. The kernel of `ops.msm._glv_stream_packed`."""
    px, py = px.contiguous(), py.contiguous()
    n = px.shape[-1]
    check_tensor("glv_records x", px, (24, n))
    check_tensor("glv_records y", py, (24, n))
    inf = _lane_row("glv_records inf", pinf, n, torch.bool)
    neg = _lane_row("glv_records neg1", neg1, n, torch.bool)
    out = torch.empty((49, 2 * n), dtype=torch.int32, device=px.device)
    if n:
        with torch.cuda.device(px.device):
            rc = lib().curdle_glv_records(
                px.data_ptr(), py.data_ptr(), inf.data_ptr(), neg.data_ptr(), out.data_ptr(), n, stream_ptr()
            )
        check_launch("glv_records", rc)
        launch_counts["glv_records"] += 1
    return out


def launch_floor() -> None:
    """One launch of an empty kernel on the current stream: the fixed cost of
    a launch, timed beside the field kernels. On no path, and not counted."""
    check_launch("launch_floor", lib().curdle_launch_floor(stream_ptr()))
