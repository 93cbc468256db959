"""The CUDA side of the package: build, binding, launch counts, and the
elementwise point kernel's wrappers.

Counterpart of the JAX package's `ops.pallas_g1` (`_build_kernel` and its
`jadd` / `jdbl` / `jmadd` wrappers). The kernels are hand-written CUDA C++
for sm_90a under ../csrc (`fq.cuh`, `g1.cuh`, `kernels.cu`, plain C
interface). They are compiled with `nvcc` at first use into `build/` inside
the package directory and loaded with `ctypes`; nothing is built or imported
from CUDA when this module is imported.

`point_op` is bound by operations, not bytes: a complete Jacobian add is 16
Montgomery products (300 32-bit multiplies each) on 6 field elements read
and 3 written. One thread computes one lane.

Every wrapper launches on `torch.cuda.current_stream()`, allocates its outputs
with `torch.empty`, raises on a non-zero return, and adds one to its entry in
`launch_counts` where it launches — nowhere else. There is no fallback: a
CUDA tensor goes to the kernel or the call raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from curdleproofs_tpu_torch.ops.fieldspec import FQ_SPEC
from curdleproofs_tpu_torch.ops.glv import BETA as _GLV_BETA

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("fq.cuh", "g1.cuh", "kernels.cu")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

KERNEL_NAMES = ("scan_sel", "scan_full", "gather_u32", "point_op")

# launches per kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {k: 0 for k in KERNEL_NAMES}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # nvcc wall time of this process's build


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _beta_mont_limbs() -> np.ndarray:
    """The GLV endomorphism constant beta in Montgomery form, (24,) limbs."""
    v = _GLV_BETA * FQ_SPEC.r_mod % FQ_SPEC.modulus
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(24)], dtype=np.uint32)


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.curdle_scan_sel.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.curdle_scan_full.argtypes = [p, p, p, i, i, i, p]
    lib.curdle_gather_u32.argtypes = [p, p, p, i, i, i, i, p]
    lib.curdle_point_op.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, p]
    for fn in (
        lib.curdle_scan_sel,
        lib.curdle_scan_full,
        lib.curdle_gather_u32,
        lib.curdle_point_op,
    ):
        fn.restype = ctypes.c_int


def lib() -> ctypes.CDLL:
    """The kernels' shared library, built from ../csrc at first use. The file
    name carries a hash of the sources, so an edit never loads a stale build."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libcurdle_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        nvcc = _find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(CSRC_DIR / "kernels.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)
    loaded = ctypes.CDLL(str(so))
    _bind(loaded)
    _lib = loaded
    return loaded


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
