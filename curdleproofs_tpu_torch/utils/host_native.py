"""The package's native host library: GLV split, streaming-MSM host prep and
the route solver, in C with a plain C interface (../csrc/host_prep.c,
../csrc/route.c).

Counterpart of the JAX package's `_g1_native.glv_decompose_batch`,
`_g1_native.msm_prep_batch` and `_route_native.decompose`, which are CPython
extensions there. Here the two sources are compiled into one shared library
by the machine's C compiler at first use, into `build/` inside the package
directory beside the CUDA libraries, and loaded with `ctypes`; the file name
carries a hash of the sources and the flags, so an edit never loads a stale
build. Nothing is built when this module is imported.

Where the machine has no C compiler `available()` is false and the callers
take their numpy versions, which give identical arrays (the tests hold one
against the other). A compiler that is found and fails raises. ctypes drops
the interpreter lock for the length of a call, so calls from several threads
run side by side (the route solves of ops.msm rely on it).
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
import warnings
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("host_prep.c", "route.c")
# no -march=native: the library's file name is shared between machines
CC_FLAGS = ("-O3", "-fPIC", "-shared")
OPENMP_FLAG = "-fopenmp"

_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U64P = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_I, _I64 = ctypes.c_int, ctypes.c_int64
# C entry points and their argument types (all return int)
ENTRY_POINTS = {
    "curdle_host_openmp_threads": [],
    "curdle_glv_decompose_batch": [_U8P, _I64, _U64P, _U8P, _U64P],
    "curdle_msm_prep_batch": [
        _U8P, _I64, _I, _I, _I32P, _I, _U8P, _I32P, _I32P, _I32P, _I32P, _I32P,
        ctypes.POINTER(ctypes.c_int32),
    ],
    "curdle_route_decompose": [_I, _I, _I, _I32P, _I32P, _I32P, _I32P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # compiler wall time of this process's build
built_with: Optional[str] = None  # the compiler that built it in this process


@functools.lru_cache(maxsize=None)
def find_compilers() -> Tuple[str, ...]:
    """The machine's C compilers, in the order they are tried: $CC, cc, gcc,
    clang, each once. Looked up once per process: available() is asked on
    every MSM."""
    found: List[str] = []
    for name in (os.environ.get("CC"), "cc", "gcc", "clang"):
        path = shutil.which(name) if name else None
        if path and os.path.realpath(path) not in [os.path.realpath(f) for f in found]:
            found.append(path)
    return tuple(found)


def find_cc() -> Optional[str]:
    """The first C compiler of the machine, or None."""
    return next(iter(find_compilers()), None)


def available() -> bool:
    """Whether the native library can be had: built already, or a C compiler
    to build it with."""
    return _lib is not None or find_cc() is not None


def _flags(openmp: bool) -> tuple:
    return CC_FLAGS + ((OPENMP_FLAG,) if openmp else ())


def library_path(openmp: bool) -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(_flags(openmp)).encode())
    return BUILD_DIR / f"libcurdle_host_{h.hexdigest()[:16]}.so"


def _compile(cc: str, openmp: bool, out: Path) -> subprocess.CompletedProcess:
    cmd = [cc, *_flags(openmp), "-o", str(out), *(str(CSRC_DIR / s) for s in SOURCES)]
    return subprocess.run(cmd, capture_output=True, text=True)


def lib() -> ctypes.CDLL:
    """The library, bound and ready to call; built first where it is missing.
    With OpenMP where one of the machine's compilers links it, without where
    none does."""
    global _lib, build_seconds, built_with
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:  # another thread built it meanwhile
            return _lib
        so = next((p for p in (library_path(True), library_path(False)) if p.exists()), None)
        if so is None:
            compilers = find_compilers()
            if not compilers:
                raise RuntimeError("no C compiler found: the native host library cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            errors = []
            # every compiler with OpenMP first (a toolchain may lack its
            # runtime library), then every compiler without
            for openmp, cc in ((o, c) for o in (True, False) for c in compilers):
                so = library_path(openmp)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                proc = _compile(cc, openmp, tmp)
                if proc.returncode == 0:
                    os.replace(tmp, so)
                    built_with = cc
                    break
                errors.append(f"{cc} failed ({proc.returncode}, openmp={openmp}):\n{proc.stderr}")
            else:
                raise RuntimeError("\n".join(errors))
            build_seconds = time.perf_counter() - t0
        loaded = ctypes.CDLL(str(so))
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        if not loaded.curdle_host_openmp_threads():
            warnings.warn(
                "curdleproofs_tpu_torch: no compiler of this machine links OpenMP; "
                "the native host prep runs on one thread",
                RuntimeWarning,
                stacklevel=2,
            )
        _lib = loaded
        return loaded


def openmp_threads() -> int:
    """Threads an OpenMP region of the library runs on; 0 when it was built
    without OpenMP."""
    return int(lib().curdle_host_openmp_threads())


def _check(name: str, rc: int) -> None:
    if rc == -2:
        raise MemoryError(f"{name}: out of memory")
    if rc != 0:
        raise ValueError(f"{name}: bad arguments (code {rc})")


def _scalar_bytes(scalars: np.ndarray) -> np.ndarray:
    """(16, n) canonical limbs (16-bit values) -> (n, 32) little-endian bytes."""
    le = np.ascontiguousarray(np.asarray(scalars).T.astype("<u2"))
    return le.view(np.uint8).reshape(le.shape[0], 32)


def glv_decompose_batch(scalars: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(16, n) canonical Fr limbs -> (k1 (n, 3) u64 magnitudes, neg1 (n,) u8,
    k2 (n, 3) u64), little-endian 64-bit limbs."""
    buf = _scalar_bytes(scalars)
    n = buf.shape[0]
    k1 = np.empty((n, 3), np.uint64)
    k2 = np.empty((n, 3), np.uint64)
    neg = np.empty(n, np.uint8)
    _check("glv_decompose_batch", lib().curdle_glv_decompose_batch(buf, n, k1, neg, k2))
    return k1, neg, k2


def msm_prep_batch(scalars: np.ndarray, c: int, L: int, slot_options: Sequence[int]):
    """The streaming-MSM host prep in one call. scalars (16, n) canonical
    limbs; 2n GLV lanes over L scan lanes; slot_options ascending.

    Returns (neg1 (n,) bool, order_cm (W, 2n) i32, bidx (W, B-1) i32,
    lidx (W, B-1) i32, sel (W*T, S) i32 or None, bpos (W, B-1) i32 or None,
    S) with S == 0 and sel, bpos None when no slot option fits."""
    buf = _scalar_bytes(scalars)
    n = buf.shape[0]
    n2 = 2 * n
    if not 1 <= c <= 16 or L <= 0 or n2 % L:
        raise ValueError("msm_prep_batch: bad c / L")
    W = -(-130 // c)
    Bm1 = (1 << c) - 1
    T = n2 // L
    opts = np.asarray(sorted(slot_options), dtype=np.int32)
    neg = np.empty(n, np.uint8)
    order_cm = np.empty((W, n2), np.int32)
    bidx = np.empty((W, Bm1), np.int32)
    lidx = np.empty((W, Bm1), np.int32)
    sel = np.empty(W * T * (int(opts.max()) if opts.size else 0), np.int32)
    bpos = np.empty((W, Bm1), np.int32)
    S = ctypes.c_int32(0)
    rc = lib().curdle_msm_prep_batch(
        buf, n, c, L, opts, opts.size, neg, order_cm, bidx, lidx, sel, bpos, ctypes.byref(S)
    )
    _check("msm_prep_batch", rc)
    S = int(S.value)
    if not S:
        return neg.astype(bool), order_cm, bidx, lidx, None, None, 0
    return neg.astype(bool), order_cm, bidx, lidx, sel[: W * T * S].reshape(W * T, S), bpos, S


def route_decompose(r: int, c: int, src: np.ndarray):
    """Route W permutations of n = r*c elements: src (W, n) int32 ->
    (idx1 (W, r, c), idx2 (W, c, r), idx3 (W, r, c)) int32; see
    ops.route.decompose."""
    n = r * c
    src = np.ascontiguousarray(src, dtype=np.int32).reshape(-1, n)
    W = src.shape[0]
    idx1 = np.empty((W, r, c), np.int32)
    idx2 = np.empty((W, c, r), np.int32)
    idx3 = np.empty((W, r, c), np.int32)
    _check("route_decompose", lib().curdle_route_decompose(r, c, W, src, idx1, idx2, idx3))
    return idx1, idx2, idx3
