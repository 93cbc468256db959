"""The CUDA side of the package: build, binding, launch counts, and the
wrappers of the elementwise point kernel and of the scalar-multiplication
ladders.

Counterpart of the JAX package's `ops.pallas_g1` (`_build_kernel` with its
`jadd` / `jdbl` / `jmadd` wrappers, and `scalar_mul_glv`, `scalar_mul`,
`scalar_mul_w1` over `_build_glv_ladder_kernel`, `_build_glv_ladder_w4_kernel`,
`_build_ladder_w3_kernel`, `_build_ladder_kernel`). The kernels are
hand-written CUDA C++ for sm_90a under ../csrc (`fq.cuh`, `g1.cuh`;
`kernels.cu` and `ladders.cu`, plain C interfaces). Each `.cu` is compiled
with `nvcc` at first use into a shared library of its own under `build/`
inside the package directory, both compilers started together, and loaded
with `ctypes`; nothing is built or imported from CUDA when this module is
imported.

`point_op` and the ladders are bound by operations, not bytes: a complete
Jacobian add is 16 Montgomery products (300 32-bit multiplies each) on 6
field elements read and 3 written, and a ladder chains 2,300 to 4,600 such
products per lane between reading a point and writing one. One thread
computes one lane.

Every wrapper launches on `torch.cuda.current_stream()`, allocates its outputs
with `torch.empty`, raises on a non-zero return, and adds one to its entry in
`launch_counts` where it launches — nowhere else. There is no fallback: a
CUDA tensor goes to the kernel or the call raises. The plain PyTorch versions
of the ladders stand in `ops.g1`, whose `scalar_mul*` functions hand CPU
tensors to them and CUDA tensors to the wrappers here.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
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
        "curdle_scan_sel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "curdle_scan_full": [_P, _P, _P, _I, _I, _I, _P],
        "curdle_gather_u32": [_P, _P, _P, _I, _I, _I, _I, _P],
        "curdle_point_op": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    },
    "ladders.cu": {
        "curdle_ladder_glv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
        "curdle_ladder_w3": [_P, _P, _P, _P, _P, _I, _P],
        "curdle_ladder_w1": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
    },
}

KERNEL_NAMES = (
    "scan_sel",
    "scan_full",
    "gather_u32",
    "point_op",
    "ladder_glv_w3",
    "ladder_glv_w4",
    "ladder_w3",
    "ladder_w1",
)

# launches per kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {k: 0 for k in KERNEL_NAMES}

# GLV ladder window width, 3 or 4: 43 iterations over 7-entry tables or 33
# over 15-entry tables. The JAX package's knob, under its name.
GLV_W = int(os.environ.get("CURDLEPROOFS_GLV_W", "3"))

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
    together."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    paths = {unit: library_path(unit) for unit in ENTRY_POINTS}
    running = []
    t0 = time.perf_counter()
    for unit, so in paths.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
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
    _lib = bound
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
# point_op
# ---------------------------------------------------------------------------

_BODIES = {"jadd": 0, "jdbl": 1, "jmadd": 2}


def point_op(body: str, coords, qinf: Optional[torch.Tensor] = None):
    """Launch the elementwise point kernel. coords: 6 (jadd), 3 (jdbl) or 5
    (jmadd) contiguous (24, m) int32 CUDA tensors; qinf (m,) int32 for jmadd.
    Returns three (24, m) tensors (X, Y, Z)."""
    n_in = {"jadd": 6, "jdbl": 3, "jmadd": 5}[body]
    if len(coords) != n_in:
        raise ValueError(f"{body}: expected {n_in} coordinate tensors")
    m = coords[0].shape[-1]
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
            stream_ptr(),
        )
    check_launch(f"point_op[{body}]", rc)
    launch_counts["point_op"] += 1
    return tuple(outs)


def _flat(arrs):
    """Broadcast (24, *B) tensors to one shape and flatten to contiguous
    (24, m)."""
    arrs = torch.broadcast_tensors(*arrs)
    shape = arrs[0].shape
    return [a.reshape(24, -1).contiguous() for a in arrs], shape


def jadd(p, q):
    """Complete Jacobian + Jacobian add on (24, *B) CUDA coords."""
    from curdleproofs_tpu_torch.ops.g1 import JPoints

    flats, shape = _flat([p.x, p.y, p.z, q.x, q.y, q.z])
    x, y, z = point_op("jadd", flats)
    return JPoints(x.reshape(shape), y.reshape(shape), z.reshape(shape))


def jdbl(p):
    """Jacobian doubling on (24, *B) CUDA coords."""
    from curdleproofs_tpu_torch.ops.g1 import JPoints

    flats, shape = _flat([p.x, p.y, p.z])
    x, y, z = point_op("jdbl", flats)
    return JPoints(x.reshape(shape), y.reshape(shape), z.reshape(shape))


def jmadd(p, q):
    """Complete Jacobian + affine mixed add on (24, *B) CUDA coords."""
    from curdleproofs_tpu_torch.ops.g1 import JPoints

    flats, shape = _flat([p.x, p.y, p.z, q.x, q.y])
    qinf = q.inf.expand(shape[1:]).reshape(-1).to(torch.int32).contiguous()
    x, y, z = point_op("jmadd", flats, qinf)
    return JPoints(x.reshape(shape), y.reshape(shape), z.reshape(shape))


# ---------------------------------------------------------------------------
# the scalar-multiplication ladders
# ---------------------------------------------------------------------------


def _lane_row(name: str, row: torch.Tensor, m: int) -> torch.Tensor:
    """A per-lane flag (bool or integer, any batch shape) as the (m,) int32
    row the kernels read."""
    flat = row.reshape(-1).to(torch.int32).contiguous()
    check_tensor(name, flat, (m,))
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


def scalar_mul_glv(points, s1, neg1, s2, w: Optional[int] = None):
    """Launch the GLV dual-table ladder: per lane k*P = k1*P + k2*phi(P).

    points: APoints of (24, *B) CUDA coords; s1, s2: (9, *B) int32 limbs of
    |k1|, k2; neg1: (*B,) sign of k1 (as `ops.glv.decompose` returns them);
    w: window width 3 or 4 (default GLV_W). Returns Jacobian (24, *B)."""
    from curdleproofs_tpu_torch.ops.g1 import JPoints

    w = GLV_W if w is None else w
    if w not in (3, 4):
        raise ValueError(f"scalar_mul_glv: window width must be 3 or 4, got {w}")
    px, py, shape, m = _ladder_base("scalar_mul_glv", points)
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
                *(o.data_ptr() for o in outs), m, stream_ptr(),
            )
        check_launch(f"ladder_glv_w{w}", rc)
        launch_counts[f"ladder_glv_w{w}"] += 1
    return JPoints(*(o.reshape(shape) for o in outs))


def scalar_mul(points, scalars):
    """Per lane k*P over (16, *B) canonical Fr limbs with the 3-bit windowed
    ladder. The table {1..7}P is built with six launches of the point kernel
    (dbl, madd, dbl, madd, dbl, madd), then one `ladder_w3` launch runs the 85
    window iterations. Returns Jacobian (24, *B)."""
    from curdleproofs_tpu_torch.ops.g1 import APoints, JPoints, lift

    px, py, shape, m = _ladder_base("scalar_mul", points)
    sc = scalars.reshape(16, -1).contiguous()
    check_tensor("scalar_mul scalars", sc, (16, m))
    outs = _ladder_outputs(px, m)
    if m:
        base = APoints(px, py, points.inf.reshape(-1))
        t1 = lift(base)
        t2 = jdbl(t1)
        t3 = jmadd(t2, base)
        t4 = jdbl(t2)
        t5 = jmadd(t4, base)
        t6 = jdbl(t3)
        t7 = jmadd(t6, base)
        table = torch.stack([torch.cat(tuple(t), dim=0) for t in (t1, t2, t3, t4, t5, t6, t7)])
        check_tensor("scalar_mul table", table, (7, 72, m))
        with torch.cuda.device(px.device):
            rc = lib().curdle_ladder_w3(
                table.data_ptr(), sc.data_ptr(), *(o.data_ptr() for o in outs), m, stream_ptr()
            )
        check_launch("ladder_w3", rc)
        launch_counts["ladder_w3"] += 1
    return JPoints(*(o.reshape(shape) for o in outs))


def scalar_mul_w1(points, scalars):
    """Per lane k*P with the bitwise ladder (255 doublings, a complete mixed
    add per set bit); the cross-check of the windowed ladders. Returns
    Jacobian (24, *B)."""
    from curdleproofs_tpu_torch.ops.g1 import JPoints

    px, py, shape, m = _ladder_base("scalar_mul_w1", points)
    sc = scalars.reshape(16, -1).contiguous()
    check_tensor("scalar_mul_w1 scalars", sc, (16, m))
    inf = _lane_row("scalar_mul_w1 inf", points.inf, m)
    outs = _ladder_outputs(px, m)
    if m:
        with torch.cuda.device(px.device):
            rc = lib().curdle_ladder_w1(
                px.data_ptr(), py.data_ptr(), inf.data_ptr(), sc.data_ptr(),
                *(o.data_ptr() for o in outs), m, stream_ptr(),
            )
        check_launch("ladder_w1", rc)
        launch_counts["ladder_w1"] += 1
    return JPoints(*(o.reshape(shape) for o in outs))
