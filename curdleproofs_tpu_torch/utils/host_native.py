"""The package's native host library: GLV split, streaming-MSM host prep,
the route solver, the host G1 backend and the Keccak / STROBE / Merlin
transcript, in C with a plain C interface (../csrc/host_prep.c,
../csrc/route.c, ../csrc/g1_host.c, ../csrc/keccak.c).

Counterpart of the JAX package's `_g1_native`, `_keccak_native` and
`_route_native`, which are CPython extensions there. Here the sources are
compiled into one shared library by the machine's C compiler at first use,
into `build/` inside the package directory beside the CUDA libraries, and
loaded with `ctypes`; the file name carries a hash of the sources and the
flags, so an edit never loads a stale build. Nothing is built when this
module is imported.

Where the machine has no C compiler `available()` is false and the callers
take their numpy and pure-Python versions, which give identical arrays,
points and bytes (the tests hold one against the other). A compiler that is found and fails raises. ctypes drops
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
SOURCES = ("host_prep.c", "route.c", "g1_host.c", "keccak.c")
HEADERS = ("glv_host.h",)  # hashed with the sources
# no -march=native: the library's file name is shared between machines
CC_FLAGS = ("-O3", "-fPIC", "-shared")
OPENMP_FLAG = "-fopenmp"

_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U64P = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_I, _I64 = ctypes.c_int, ctypes.c_int64
_B = ctypes.c_char_p  # a bytes object in, a ctypes char buffer out
# C entry points and their argument types (all return int)
ENTRY_POINTS = {
    "curdle_host_openmp_threads": [],
    "curdle_glv_decompose_batch": [_U8P, _I64, _U64P, _U8P, _U64P],
    "curdle_msm_prep_batch": [
        _U8P, _I64, _I, _I, _I32P, _I, _U8P, _I32P, _I32P, _I32P, _I32P, _I32P,
        ctypes.POINTER(ctypes.c_int32),
    ],
    "curdle_route_decompose": [_I, _I, _I, _I32P, _I32P, _I32P, _I32P],
    # g1_host.c: points as 96-byte x || y plus one infinity byte each
    "curdle_g1_msm": [_B, _B, _B, _I64, _B, _B],
    "curdle_g1_mul_batch": [_B, _B, _B, _I64, _B, _B],
    "curdle_g1_add_batch": [_B, _B, _B, _B, _I64, _B, _B],
    "curdle_g1_sum": [_B, _B, _I64, _B, _B],
    "curdle_g1_compress_batch": [_B, _B, _I64, _B],
    "curdle_g1_decompress_batch": [_B, _I64, _I, _B, _B],
    "curdle_g1_jacobian_to_affine_batch": [_B, _I64, _B, _B],
    "curdle_g1_subgroup_check_batch": [_B, _B, _I64],
    # keccak.c: the duplex state is a writable 203-byte buffer
    "curdle_keccak_f1600": [_B],
    "curdle_strobe_init": [_B, _I64, _B],
    "curdle_strobe_op": [_B, _I, _B, _I64, _I, _B],
    "curdle_merlin_write": [_B, _B, _I64, _B, _I64],
    "curdle_merlin_write_many": [_B, _B, _I64, _B, _I64, _I64],
    "curdle_merlin_read": [_B, _B, _I64, _B, _I64],
    "curdle_merlin_challenge_scalars": [_B, _B, _I64, _I64, _B],
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
    for name in SOURCES + HEADERS:
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


# ---------------------------------------------------------------------------
# the host G1 backend (csrc/g1_host.c): bytes in, bytes out. A point is 96
# bytes (x || y, big-endian canonical) plus one infinity byte, a scalar 32
# little-endian bytes.
# ---------------------------------------------------------------------------


def _g1_check(name: str, rc: int) -> None:
    if rc == 1:
        raise MemoryError(f"{name}: out of memory")
    if rc != 0:
        raise ValueError(f"{name}: code {rc}")


def _lengths(name: str, points96: bytes, inf: bytes) -> int:
    n = len(inf)
    if len(points96) != 96 * n:
        raise ValueError(f"{name}: buffer length mismatch")
    return n


def g1_msm(points96: bytes, inf: bytes, scalars32: bytes) -> Tuple[bytes, int]:
    """sum_i s_i * P_i -> (96 bytes, infinity flag)."""
    n = _lengths("g1_msm", points96, inf)
    if len(scalars32) != 32 * n:
        raise ValueError("g1_msm: buffer length mismatch")
    out, oinf = ctypes.create_string_buffer(96), ctypes.create_string_buffer(1)
    _g1_check("g1_msm", lib().curdle_g1_msm(points96, inf, scalars32, n, out, oinf))
    return out.raw, oinf.raw[0]


def g1_mul_batch(points96: bytes, inf: bytes, scalars32: bytes) -> Tuple[bytes, bytes]:
    """[s_i * P_i] -> (96 n bytes, n infinity flags)."""
    n = _lengths("g1_mul_batch", points96, inf)
    if len(scalars32) != 32 * n:
        raise ValueError("g1_mul_batch: buffer length mismatch")
    out, oinf = ctypes.create_string_buffer(96 * n), ctypes.create_string_buffer(n)
    _g1_check("g1_mul_batch", lib().curdle_g1_mul_batch(points96, inf, scalars32, n, out, oinf))
    return out.raw, oinf.raw


def g1_add_batch(a96: bytes, ainf: bytes, b96: bytes, binf: bytes) -> Tuple[bytes, bytes]:
    """[A_i + B_i] -> (96 n bytes, n infinity flags)."""
    n = _lengths("g1_add_batch", a96, ainf)
    if _lengths("g1_add_batch", b96, binf) != n:
        raise ValueError("g1_add_batch: buffer length mismatch")
    out, oinf = ctypes.create_string_buffer(96 * n), ctypes.create_string_buffer(n)
    _g1_check("g1_add_batch", lib().curdle_g1_add_batch(a96, ainf, b96, binf, n, out, oinf))
    return out.raw, oinf.raw


def g1_sum(points96: bytes, inf: bytes) -> Tuple[bytes, int]:
    """sum_i P_i -> (96 bytes, infinity flag)."""
    n = _lengths("g1_sum", points96, inf)
    out, oinf = ctypes.create_string_buffer(96), ctypes.create_string_buffer(1)
    _g1_check("g1_sum", lib().curdle_g1_sum(points96, inf, n, out, oinf))
    return out.raw, oinf.raw[0]


def g1_compress_batch(points96: bytes, inf: bytes) -> bytes:
    """The 48-byte compressed encodings, concatenated."""
    n = _lengths("g1_compress_batch", points96, inf)
    out = ctypes.create_string_buffer(48 * n)
    _g1_check("g1_compress_batch", lib().curdle_g1_compress_batch(points96, inf, n, out))
    return out.raw


def g1_decompress_batch(comp48: bytes, check: bool) -> Tuple[bytes, bytes, int]:
    """len(comp48) / 48 encodings -> (96 n bytes, n infinity flags, the index
    of the first bad encoding or -1; the outputs from there on are
    unwritten)."""
    if len(comp48) % 48:
        raise ValueError("g1_decompress_batch: length not a multiple of 48")
    n = len(comp48) // 48
    out, oinf = ctypes.create_string_buffer(96 * n), ctypes.create_string_buffer(n)
    rc = lib().curdle_g1_decompress_batch(comp48, n, int(check), out, oinf)
    return out.raw, oinf.raw, -1 - rc if rc < 0 else -1


def g1_jacobian_to_affine_batch(xyz144: bytes) -> Tuple[bytes, bytes]:
    """n Jacobian points (X || Y || Z, 48-byte big-endian canonical each) ->
    (96 n bytes, n infinity flags)."""
    if len(xyz144) % 144:
        raise ValueError("g1_jacobian_to_affine_batch: length not a multiple of 144")
    n = len(xyz144) // 144
    out, oinf = ctypes.create_string_buffer(96 * n), ctypes.create_string_buffer(n)
    _g1_check("g1_jacobian_to_affine_batch", lib().curdle_g1_jacobian_to_affine_batch(xyz144, n, out, oinf))
    return out.raw, oinf.raw


def g1_subgroup_check_batch(points96: bytes, inf: bytes) -> int:
    """The index of the first point outside the prime-order subgroup, or -1."""
    n = _lengths("g1_subgroup_check_batch", points96, inf)
    rc = lib().curdle_g1_subgroup_check_batch(points96, inf, n)
    return -1 - rc if rc < 0 else -1


# ---------------------------------------------------------------------------
# Keccak-f[1600] and the STROBE / Merlin duplex (csrc/keccak.c). The duplex
# state is a writable 203-byte buffer the caller owns (a ctypes view of a
# bytearray): [0:200] keccak state, [200] pos, [201] pos_begin,
# [202] cur_flags.
# ---------------------------------------------------------------------------

STROBE_STATE_BYTES = 203
_STROBE_ERRORS = {
    1: "STROBE op continuation with mismatched flags",
    2: "transport flags not supported",
    3: "bad strobe opcode",
    4: "bad length",
}


def _strobe_check(rc: int) -> None:
    if rc:
        raise ValueError(_STROBE_ERRORS.get(rc, f"strobe: code {rc}"))


def keccak_f1600(state: bytes) -> bytes:
    """Keccak-f[1600] of a 200-byte state (little-endian lanes)."""
    if len(state) != 200:
        raise ValueError("state must be exactly 200 bytes")
    buf = ctypes.create_string_buffer(bytes(state), 200)
    lib().curdle_keccak_f1600(buf)
    return buf.raw


def strobe_state(ba: bytearray):
    """A ctypes view of a 203-byte bytearray, to pass as the duplex state."""
    if len(ba) != STROBE_STATE_BYTES:
        raise ValueError("strobe state must be a writable 203-byte buffer")
    return (ctypes.c_char * STROBE_STATE_BYTES).from_buffer(ba)


def strobe_init(state, label: bytes) -> None:
    lib().curdle_strobe_init(label, len(label), state)


def strobe_op(state, opcode: int, data: bytes = b"", more: bool = False, n: int = 0) -> Optional[bytes]:
    """One STROBE operation: 0 meta_ad, 1 ad, 2 key (over data), 3 prf (n
    bytes, returned)."""
    out = ctypes.create_string_buffer(n) if opcode == 3 else None
    _strobe_check(lib().curdle_strobe_op(state, opcode, data, n if opcode == 3 else len(data), int(more), out))
    return out.raw if out is not None else None


def merlin_write(state, label: bytes, msg: bytes) -> None:
    _strobe_check(lib().curdle_merlin_write(state, label, len(label), msg, len(msg)))


def merlin_write_many(state, label: bytes, blob: bytes, item_size: int) -> None:
    _strobe_check(lib().curdle_merlin_write_many(state, label, len(label), blob, len(blob), item_size))


def merlin_read(state, label: bytes, n: int) -> bytes:
    out = ctypes.create_string_buffer(n)
    _strobe_check(lib().curdle_merlin_read(state, label, len(label), out, n))
    return out.raw


def merlin_challenge_scalars(state, label: bytes, count: int) -> bytes:
    """count accepted Fr draws, 32 little-endian bytes each."""
    out = ctypes.create_string_buffer(32 * count)
    _strobe_check(lib().curdle_merlin_challenge_scalars(state, label, len(label), count, out))
    return out.raw
