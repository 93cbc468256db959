"""The three field programs of the port (csrc/field_kernels.cu): the batched
decompression and compression of `ops.compress` and the GLV stream records
of `ops.msm`.

On the CPU: each of `_decompress_device`, `_compress_device` and
`_glv_stream_packed` hands a CPU tensor to its plain version and a CUDA
tensor to its wrapper in `ops.cuda_g1` (driven against a stand-in for the
built library: the entry point's arity, the shapes and types it is given,
one launch counted); the ctypes signatures of the three entry points are
their C declarations; the constants written into the `.cu` as literal words
are R^2, 4R, (p-1)/2 + 1, beta R and (p+1)/4 of `fields.FQ_MOD` and
`glv.BETA`; and the plain decode and encode equal the JAX package's jitted
programs on the same numpy-seeded inputs, with x = 0 (infinity),
non-residue lanes and both signs (the plain GLV records against the JAX
package: tests/test_torch_msm.py). On a card (`-m gpu`): each kernel bit for bit against its
plain version. The JAX package is imported only inside fixtures, so the GPU
tests run where it is not installed (`--noconftest`)."""
import contextlib
import re
import types

import numpy as np
import pytest
import torch

from curdleproofs_tpu_torch import curve
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FQ_MOD, FR_MOD, Fr
from curdleproofs_tpu_torch.ops import compress as tcompress
from curdleproofs_tpu_torch.ops import cuda_g1
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import glv as tglv
from curdleproofs_tpu_torch.ops import msm as tmsm
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, ints_to_limbs, limbs_to_ints, to_reference

torch.set_num_threads(1)

N = 24  # lanes of every comparison
UNIT = "field_kernels.cu"
R = 1 << 384


def _nonresidue_xs(k):
    """The k smallest x with no point on the curve (x^3 + 4 a non-residue)."""
    out, x = [], 1
    while len(out) < k:
        if curve.fq_sqrt((x**3 + 4) % FQ_MOD) is None:
            out.append(x)
        x += 1
    return out


def field_inputs(seed=0xF1E1D):
    """x (24, N) canonical limbs and sign flags (N,): curve points with both
    signs, x = 0 (the lanes that carry infinity), non-residues, p - 1 and
    uniform x."""
    rng = np.random.default_rng(seed)
    pts = curve.mul_host_batch([G1()] * 10, [Fr(int.from_bytes(rng.bytes(32), "little") % FR_MOD) for _ in range(10)])
    xs = [p.x for p in pts] + [0, 0] + _nonresidue_xs(3) + [FQ_MOD - 1]
    xs += [int.from_bytes(rng.bytes(48), "little") % FQ_MOD for _ in range(N - len(xs))]
    signs = rng.integers(0, 2, N).astype(bool)
    signs[10], signs[11] = False, True
    return ints_to_limbs(xs, 24), signs


def record_inputs(seed=0x61F):
    """Affine Montgomery points (24, N) with identity lanes (zero
    coordinates), their inf flags and mixed neg1 flags."""
    rng = np.random.default_rng(seed)
    pts = curve.mul_host_batch([G1()] * N, [Fr(int.from_bytes(rng.bytes(32), "little") % FR_MOD) for _ in range(N)])
    pts[3] = pts[17] = G1.identity()
    ap = tog.pack_points(pts, "cpu")
    neg1 = rng.integers(0, 2, N).astype(bool)
    neg1[3], neg1[17] = True, False
    return to_reference(ap.x), to_reference(ap.y), to_reference(ap.inf), neg1


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's jitted programs and point struct."""
    import jax.numpy as jnp

    from curdleproofs_tpu.ops import compress as jcompress
    from curdleproofs_tpu.ops import g1 as jg1

    return types.SimpleNamespace(jnp=jnp, compress=jcompress, g1=jg1)


def _same(t, j):
    return np.array_equal(to_reference(t), np.asarray(j))


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------


def test_decompress_plain_equals_jax(jax_side):
    x, signs = field_inputs()
    xm, ym, ok = tcompress._decompress_plain(from_reference(x, "cpu"), from_reference(signs, "cpu"))
    jxm, jym, jok = jax_side.compress._decompress_device(jax_side.jnp.asarray(x), jax_side.jnp.asarray(signs))
    assert _same(xm, jxm) and _same(ym, jym) and _same(ok, jok)
    ok_np = to_reference(ok)
    assert ok_np[:12].all() and not ok_np[12:15].any()  # curve points and x = 0 / non-residues
    # the lanes with a root give the points back, sign for sign
    got = tog.unpack_points(tog.APoints(xm[:, :10], ym[:, :10], torch.zeros(10, dtype=torch.bool)))
    assert [p.x for p in got] == limbs_to_ints(x[:, :10])
    assert [p.y > (FQ_MOD - 1) // 2 for p in got] == list(signs[:10])


def test_compress_plain_equals_jax(jax_side):
    x, signs = field_inputs()
    xm, ym, _ = tcompress._decompress_plain(from_reference(x, "cpu"), from_reference(signs, "cpu"))
    inf = torch.zeros(N, dtype=torch.bool)
    xc, largest = tcompress._compress_plain(tog.APoints(xm, ym, inf))
    jp = jax_side.g1.APoints(*(jax_side.jnp.asarray(to_reference(t)) for t in (xm, ym, inf)))
    jxc, jlargest = jax_side.compress._compress_device(jp)
    assert _same(xc, jxc) and _same(largest, jlargest)
    assert np.array_equal(to_reference(xc), x)  # the canonical x comes back
    assert np.array_equal(to_reference(largest)[:12], signs[:12])


# ---------------------------------------------------------------------------
# dispatch: CPU -> the plain version, CUDA -> the wrapper and its launch
# ---------------------------------------------------------------------------


class _CudaFlagged(torch.Tensor):
    """A CPU tensor that says it lies on the card, so the dispatch takes the
    wrapper (whose library, checks and stream are stand-ins here)."""

    @property
    def is_cuda(self):
        return True


def _flag_cuda(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_CudaFlagged, t)


@pytest.fixture
def stand_in(monkeypatch):
    """`cuda_g1.lib()` replaced by a library whose entry points record their
    arguments; the tensor checks accept any device; launch counts go back to
    what they were after the test."""
    seen = {}

    def entry(name):
        def fn(*args):
            assert len(args) == len(cuda_g1.ENTRY_POINTS[UNIT][name]), name
            seen[name] = args
            return 0

        return fn

    def check_any_device(name, t, shape, dtype=torch.int32):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape) and t.is_contiguous(), name

    for k in ("decompress", "compress", "glv_records"):
        monkeypatch.setitem(cuda_g1.launch_counts, k, cuda_g1.launch_counts[k])
    monkeypatch.setattr(cuda_g1, "lib", lambda: types.SimpleNamespace(**{n: entry(n) for n in cuda_g1.ENTRY_POINTS[UNIT]}))
    monkeypatch.setattr(cuda_g1, "check_tensor", check_any_device)
    monkeypatch.setattr(cuda_g1, "stream_ptr", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return seen


def _refuse(*args, **kwargs):
    raise AssertionError("a CPU tensor reached a kernel wrapper")


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    for name in ("decompress", "compress", "glv_records"):
        monkeypatch.setattr(cuda_g1, name, _refuse)
    before = dict(cuda_g1.launch_counts)
    x, signs = field_inputs()
    xt, st = from_reference(x, "cpu"), from_reference(signs, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tcompress._decompress_device(xt, st), tcompress._decompress_plain(xt, st)))
    ap = tog.APoints(*tcompress._decompress_plain(xt, st)[:2], torch.zeros(N, dtype=torch.bool))
    assert all(torch.equal(a, b) for a, b in zip(tcompress._compress_device(ap), tcompress._compress_plain(ap)))
    args = [from_reference(a, "cpu") for a in record_inputs()]
    assert torch.equal(tmsm._glv_stream_packed(*args), tmsm._glv_stream_packed_plain(*args))
    assert cuda_g1.launch_counts == before


def test_decompress_dispatches_cuda_tensors_to_the_kernel(stand_in):
    x, signs = field_inputs()
    before = cuda_g1.launch_counts["decompress"]
    xm, ym, ok = tcompress._decompress_device(_flag_cuda(from_reference(x, "cpu")), from_reference(signs, "cpu"))
    assert cuda_g1.launch_counts["decompress"] == before + 1
    args = stand_in["curdle_decompress"]
    assert args[-2] == N and args[-1] == 0
    assert [a.shape for a in (xm, ym, ok)] == [(24, N), (24, N), (N,)]
    assert (xm.dtype, ok.dtype) == (torch.int32, torch.bool)
    assert args[2:5] == (xm.data_ptr(), ym.data_ptr(), ok.data_ptr())


def test_compress_dispatches_cuda_tensors_to_the_kernel(stand_in):
    px, py, pinf, _ = record_inputs()
    ap = tog.APoints(_flag_cuda(from_reference(px, "cpu")), from_reference(py, "cpu"), from_reference(pinf, "cpu"))
    before = cuda_g1.launch_counts["compress"]
    xc, largest = tcompress._compress_device(ap)
    assert cuda_g1.launch_counts["compress"] == before + 1
    args = stand_in["curdle_compress"]
    assert args[-2] == N and args[2:4] == (xc.data_ptr(), largest.data_ptr())
    assert tuple(xc.shape) == (24, N) and tuple(largest.shape) == (N,) and largest.dtype == torch.bool


def test_glv_records_dispatches_cuda_tensors_to_the_kernel(stand_in):
    px, py, pinf, neg1 = record_inputs()
    # a strided view of the x rows, as points.x can be: the wrapper makes it contiguous
    wide = from_reference(np.concatenate([px, px], axis=1), "cpu")
    px_view = _flag_cuda(wide[:, ::2])
    assert not px_view.is_contiguous()
    before = cuda_g1.launch_counts["glv_records"]
    out = tmsm._glv_stream_packed(px_view, from_reference(py, "cpu"), from_reference(pinf, "cpu"), from_reference(neg1, "cpu"))
    assert cuda_g1.launch_counts["glv_records"] == before + 1
    args = stand_in["curdle_glv_records"]
    assert tuple(out.shape) == (49, 2 * N) and out.dtype == torch.int32
    assert args[4] == out.data_ptr() and args[5] == N


def test_wrappers_refuse_cpu_tensors():
    """The wrappers themselves have no CPU path: a CPU tensor is refused."""
    x = torch.zeros((24, 4), dtype=torch.int32)
    flag = torch.zeros(4, dtype=torch.bool)
    before = dict(cuda_g1.launch_counts)
    for call in (
        lambda: cuda_g1.decompress(x, flag),
        lambda: cuda_g1.compress(x, x),
        lambda: cuda_g1.glv_records(x, x, flag, flag),
    ):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert cuda_g1.launch_counts == before


# ---------------------------------------------------------------------------
# the C side: signatures and constants
# ---------------------------------------------------------------------------

_P, _I = cuda_g1.ctypes.c_void_p, cuda_g1.ctypes.c_int
ENTRY_DECLS = {
    "curdle_decompress": [_P] * 5 + [_I, _P],
    "curdle_compress": [_P] * 4 + [_I, _P],
    "curdle_glv_records": [_P] * 5 + [_I, _P],
}


@pytest.mark.parametrize("name", sorted(ENTRY_DECLS))
def test_entry_point_binding_matches_its_declaration(name):
    """ctypes argument types of each entry point are its C declaration's:
    int where the C side has int, pointers (64 bits) elsewhere, n then the
    stream last."""
    assert cuda_g1.ENTRY_POINTS[UNIT][name] == ENTRY_DECLS[name]
    src = (cuda_g1.CSRC_DIR / UNIT).read_text()
    head = f"int {name}("
    decl = src[src.index(head) : src.index("{", src.index(head))]
    args = [a.strip() for a in decl[decl.index("(") + 1 : decl.rindex(")")].split(",")]
    assert [("int " in a and "*" not in a) for a in args] == [t is _I for t in ENTRY_DECLS[name]]
    assert args[-2:] == ["int n", "void* stream"]


def test_launch_floor_binding_matches_its_declaration():
    """The empty kernel's entry point takes the stream alone."""
    assert cuda_g1.ENTRY_POINTS[UNIT]["curdle_launch_floor"] == [_P]
    src = (cuda_g1.CSRC_DIR / UNIT).read_text()
    assert "int curdle_launch_floor(void* stream) {" in src
    assert "__global__ void launch_floor_kernel() {}" in src


def _literal(src: str, name: str) -> int:
    body = re.search(name + r"\[FQ_WORDS\] = \{([^}]*)\}", src).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
    assert len(words) == 12, name
    return sum(w << (32 * i) for i, w in enumerate(words))


def _bytes(src: str, name: str, count: int) -> list:
    body = re.search(name + r"\[FQ_SQRT_STEPS\] = \{([^}]*)\}", src).group(1)
    vals = [int(v) for v in re.findall(r"\d+", body)]
    assert len(vals) == count and all(0 <= v < 256 for v in vals), name
    return vals


def test_constants_are_the_fields():
    src = (cuda_g1.CSRC_DIR / UNIT).read_text()
    p = FQ_MOD
    assert _literal(src, "FQ_R2") == R * R % p
    assert _literal(src, "FQ_FOUR_MONT") == 4 * R % p
    assert _literal(src, "FQ_HALF_P1") == (p - 1) // 2 + 1
    beta = _literal(src, "FQ_BETA_MONT")
    assert beta == tglv.BETA * R % p
    assert beta == sum(w << (32 * i) for i, w in enumerate(cuda_g1._beta_words()))  # the GLV ladder's
    assert pow(tglv.BETA, 3, p) == 1 and tglv.BETA != 1
    # the square-root chain replays to (p + 1) / 4: odd digits below 32,
    # each step shifting at least the digit's width
    steps = int(re.search(r"FQ_SQRT_STEPS = (\d+);", src).group(1))
    odd = int(re.search(r"FQ_SQRT_ODD_POWERS = (\d+);", src).group(1))
    shift, digit = (_bytes(src, name, steps) for name in ("FQ_SQRT_SHIFT", "FQ_SQRT_DIGIT"))
    exp = digit[0]
    for s, d in zip(shift[1:], digit[1:]):
        assert d == 0 or (d % 2 == 1 and d < 2 * odd and s >= d.bit_length())
        exp = (exp << s) + d
    assert exp == (p + 1) // 4
    assert sum(shift) == 375 and sum(1 for d in digit[1:] if d) == 66  # the kernel's comment
    # the header's p and Montgomery one, which the kernels share with the others
    fq = (cuda_g1.CSRC_DIR / "fq.cuh").read_text()
    assert _literal(fq, "FQ_P") == p and _literal(fq, "FQ_ONE") == R % p


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_decompress_kernel_equals_plain(card):
    x, signs = field_inputs()
    xd, sd = from_reference(x, card), from_reference(signs, card)
    before = cuda_g1.launch_counts["decompress"]
    got = tcompress._decompress_device(xd, sd)
    assert cuda_g1.launch_counts["decompress"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, tcompress._decompress_plain(xd, sd)))


@pytest.mark.gpu
def test_compress_kernel_equals_plain(card):
    x, signs = field_inputs()
    xm, ym, _ = tcompress._decompress_device(from_reference(x, card), from_reference(signs, card))
    ap = tog.APoints(xm, ym, torch.zeros(N, dtype=torch.bool, device=card))
    before = cuda_g1.launch_counts["compress"]
    got = tcompress._compress_device(ap)
    assert cuda_g1.launch_counts["compress"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, tcompress._compress_plain(ap)))


@pytest.mark.gpu
def test_glv_records_kernel_equals_plain(card):
    args = [from_reference(a, card) for a in record_inputs()]
    before = cuda_g1.launch_counts["glv_records"]
    got = tmsm._glv_stream_packed(*args)
    assert cuda_g1.launch_counts["glv_records"] == before + 1
    assert torch.equal(got, tmsm._glv_stream_packed_plain(*args))
