"""Thread groups of the point kernel and of the ladders (ops.cuda_g1): the
launch geometry covers every lane exactly once, the picks shrink the group
as the width grows, the wrappers refuse a group that was not built, the
ladders' C entry points are bound with their group and grid (ladder_w1's
wrapper driven against a stand-in for the library), and the plain formulas
the kernels are held against equal the JAX package's, limb for limb, at a
ragged width with one lane in each branch. CPU only (the kernels
themselves: tests/test_torch_cuda_kernels.py on a card)."""
import contextlib
import random
import types

import jax
import numpy as np
import pytest
import torch

from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.ops import g1 as jog
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import cuda_g1
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, to_reference

torch.set_num_threads(1)

POINT_BODIES = ("jadd", "jdbl", "jmadd")
# block width -> the groups its wrapper picks at m lanes
PICKS = {
    cuda_g1.POINT_THREADS: lambda m: {cuda_g1.point_group(m, b) for b in POINT_BODIES},
    cuda_g1.LADDER_THREADS: lambda m: {cuda_g1.ladder_group(m), cuda_g1.ladder_w1_group(m)}
    | {cuda_g1.ladder_glv_group(m, w) for w in (3, 4)},
}
LADDER_PICKS = {
    "ladder": cuda_g1.ladder_group,
    "ladder_w1": cuda_g1.ladder_w1_group,
    "glv3": lambda m: cuda_g1.ladder_glv_group(m, 3),
    "glv4": lambda m: cuda_g1.ladder_glv_group(m, 4),
}


@pytest.mark.parametrize("threads", sorted(PICKS), ids=lambda t: f"threads{t}")
@pytest.mark.parametrize("group", [1, 2, 4, "picked"])
@pytest.mark.parametrize("m", [1, 3, 33, 257, 81910])
def test_groups_cover_every_lane_once(threads, group, m):
    """The grid of `launch_blocks` as the kernels read it: thread t serves
    lane t // G as thread t % G; a lane below m has G threads, and each of
    the 12 words of its result is stored by exactly one of them (k % G == q);
    the threads past m * G store nothing; warps are whole; no block is
    spare."""
    for g in PICKS[threads](m) if group == "picked" else {group}:
        assert g in cuda_g1.GROUPS
        blocks = cuda_g1.launch_blocks(m, g, threads)
        assert blocks * threads >= m * g > (blocks - 1) * threads
        assert threads % 32 == 0 and 32 % g == 0
        t = np.arange(blocks * threads)
        lane, q = t // g, t % g
        stores = lane < m
        k = np.arange(12)
        writes = stores[:, None] & (k[None, :] % g == q[:, None])
        per_word = np.bincount((lane[:, None] * 12 + k[None, :])[writes], minlength=m * 12)
        assert per_word.shape == (m * 12,) and (per_word == 1).all()
        # a thread past the end reads lane m - 1, a valid lane
        assert np.minimum(lane[~stores], m - 1).tolist() == [m - 1] * int((~stores).sum())


@pytest.mark.parametrize("pick", tuple(LADDER_PICKS) + POINT_BODIES)
def test_picks_shrink_the_group_as_the_width_grows(pick):
    fn = LADDER_PICKS.get(pick) or (lambda m: cuda_g1.point_group(m, pick))
    groups = [fn(m) for m in (1, 124, 5120, 8192, 20480, 40960, 81910, 1 << 20)]
    assert all(g in cuda_g1.GROUPS for g in groups)
    assert groups == sorted(groups, reverse=True)


@pytest.mark.parametrize("group", [0, 3, 8])
def test_wrappers_reject_a_group_not_built(group):
    coords = [torch.zeros((24, 5), dtype=torch.int32)] * 6
    with pytest.raises(ValueError, match="group"):
        cuda_g1.point_op("jadd", coords, group=group)
    with pytest.raises(ValueError, match="group"):
        cuda_g1.ladder_w3(torch.zeros((7, 72, 5), dtype=torch.int32), torch.zeros((16, 5), dtype=torch.int32), group)
    pts = tog.pack_points([G1()] * 5, "cpu")
    with pytest.raises(ValueError, match="group"):
        cuda_g1.scalar_mul(pts, torch.zeros((16, 5), dtype=torch.int32), group)
    half = torch.zeros((9, 5), dtype=torch.int32)
    for w in (3, 4):
        with pytest.raises(ValueError, match="group"):
            cuda_g1.scalar_mul_glv(pts, half, torch.zeros(5, dtype=torch.int32), half, w=w, group=group)
    with pytest.raises(ValueError, match="group"):
        cuda_g1.scalar_mul_w1(pts, torch.zeros((16, 5), dtype=torch.int32), group)


def test_glv_entry_point_takes_the_group_and_the_grid():
    """curdle_ladder_glv(w, px, py, inf, neg, s1, s2, beta, ox, oy, oz, m,
    group, blocks, stream), as csrc/ladders.cu declares it: ints where the C
    side has int, pointers (64 bits) elsewhere."""
    P, I = cuda_g1.ctypes.c_void_p, cuda_g1.ctypes.c_int
    assert cuda_g1.ENTRY_POINTS["ladders.cu"]["curdle_ladder_glv"] == [I] + [P] * 10 + [I, I, I, P]
    src = (cuda_g1.CSRC_DIR / "ladders.cu").read_text()
    decl = src[src.index("int curdle_ladder_glv(") : src.index("{", src.index("int curdle_ladder_glv("))]
    args = [a.strip() for a in decl[decl.index("(") + 1 : decl.rindex(")")].split(",")]
    assert [("int " in a and "*" not in a) for a in args] == [t is I for t in cuda_g1.ENTRY_POINTS["ladders.cu"]["curdle_ladder_glv"]]
    assert args[-4:] == ["int m", "int group", "int blocks", "void* stream"]


_P, _I = cuda_g1.ctypes.c_void_p, cuda_g1.ctypes.c_int
# unit, entry point -> its argument types and the names of its last arguments
ENTRY_DECLS = {
    ("ladders.cu", "curdle_ladder_w3"): ([_P] * 5 + [_I, _I, _I, _P], ["int m", "int group", "int blocks", "void* stream"]),
    ("ladders.cu", "curdle_ladder_w1"): ([_P] * 7 + [_I, _I, _I, _P], ["int m", "int group", "int blocks", "void* stream"]),
    ("kernels.cu", "curdle_scan_full"): ([_P] * 3 + [_I] * 4 + [_P], ["int L", "int K", "void* stream"]),
}


@pytest.mark.parametrize("unit,name", sorted(ENTRY_DECLS))
def test_entry_point_binding_matches_its_declaration(unit, name):
    """The ctypes argument types of an entry point are its C declaration's
    (csrc/*.cu): ints where the C side has int, pointers (64 bits)
    elsewhere, one for one; ladder_w3 and ladder_w1 take the group and the
    grid, the full scan its sub-chains."""
    types_, tail = ENTRY_DECLS[(unit, name)]
    assert cuda_g1.ENTRY_POINTS[unit][name] == types_
    src = (cuda_g1.CSRC_DIR / unit).read_text()
    head = f"int {name}("
    decl = src[src.index(head) : src.index("{", src.index(head))]
    args = [a.strip() for a in decl[decl.index("(") + 1 : decl.rindex(")")].split(",")]
    assert [("int " in a and "*" not in a) for a in args] == [t is _I for t in types_]
    assert args[-len(tail):] == tail


@pytest.mark.parametrize("m", [1, 31, 124, 4096, 8192, 8193, 16383])
def test_ladder_w1_wrapper_launches_its_pick(monkeypatch, m):
    """`scalar_mul_w1` against a stand-in for the built library: it passes
    the entry point its ctypes arity, m, the group `ladder_w1_group` picks and
    a grid of whole blocks with at least m * G threads and no spare block,
    and counts one launch."""
    seen = {}

    def fake(*args):
        assert len(args) == len(cuda_g1.ENTRY_POINTS["ladders.cu"]["curdle_ladder_w1"])
        seen["m"], seen["group"], seen["blocks"] = args[7:10]
        return 0

    def check_any_device(name, t, shape, dtype=torch.int32):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape) and t.is_contiguous(), name

    # the stand-in's launch is counted; the count goes back to what it was after the test
    monkeypatch.setitem(cuda_g1.launch_counts, "ladder_w1", cuda_g1.launch_counts["ladder_w1"])
    monkeypatch.setattr(cuda_g1, "lib", lambda: types.SimpleNamespace(curdle_ladder_w1=fake))
    monkeypatch.setattr(cuda_g1, "check_tensor", check_any_device)
    monkeypatch.setattr(cuda_g1, "stream_ptr", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    z = torch.zeros((24, m), dtype=torch.int32)
    pts = tog.APoints(z, z, torch.zeros(m, dtype=torch.bool))
    before = cuda_g1.launch_counts["ladder_w1"]
    out = cuda_g1.scalar_mul_w1(pts, torch.zeros((16, m), dtype=torch.int32))
    assert cuda_g1.launch_counts["ladder_w1"] == before + 1
    assert tuple(out.x.shape) == (24, m)
    g, blocks = seen["group"], seen["blocks"]
    assert seen["m"] == m and g == cuda_g1.ladder_w1_group(m) in cuda_g1.GROUPS
    assert blocks * cuda_g1.LADDER_THREADS >= m * g > (blocks - 1) * cuda_g1.LADDER_THREADS


# A ragged width with every branch of the formulas in one 8-lane stretch (one
# warp of four-thread groups): P + P, P + (-P), p at infinity, q at
# infinity, both at infinity, then uniform lanes.
M = 37
KINDS = ("dbl", "neg", "pinf", "qinf", "both")


def _jac_lanes():
    """Host points per lane: p = 2A as a doubling, q = B + C as an add (both
    with z != 1), d affine; with p == q, p == -q, p == d, p == -d on the
    doubling and cancelling lanes."""
    rng = random.Random(23)
    rand = lambda: G1() * Fr(rng.randrange(1, FR_MOD))  # noqa: E731
    O = G1.identity()
    A, B, C, D = [], [], [], []
    for i in range(M):
        kind = KINDS[i - 1] if 1 <= i <= len(KINDS) else "uniform"
        a = O if kind in ("pinf", "both") else rand()
        if kind == "dbl":
            b, c, d = a * Fr(3), -a, a * Fr(2)
        elif kind == "neg":
            b, c, d = -(a * Fr(3)), a, -(a * Fr(2))
        elif kind in ("qinf", "both"):
            b, c, d = a, -a, O
        else:
            b, c, d = rand(), rand(), rand()
        A.append(a), B.append(b), C.append(c), D.append(d)
    return A, B, C, D


@pytest.fixture(scope="module")
def ragged():
    A, B, C, D = _jac_lanes()

    def jax_pack(pts):
        return jog.pack_points([JG1.identity() if p.inf else JG1(p.x, p.y) for p in pts])

    ja, jb, jc, jd = (jax_pack(v) for v in (A, B, C, D))
    jp = jax.jit(jog._jdbl_formulas)(jog.lift(ja))
    jq = jax.jit(jog._jadd_formulas)(jog.lift(jb), jog.lift(jc))
    carry = lambda j: tog.JPoints(*(from_reference(np.asarray(a), "cpu") for a in j))  # noqa: E731
    return dict(A=A, B=B, C=C, D=D, jp=jp, jq=jq, jd=jd, tp=carry(jp), tq=carry(jq), td=tog.pack_points(D, "cpu"))


BODIES = {
    "jadd": (
        lambda o: tog._jadd_formulas(o["tp"], o["tq"]),
        lambda o: jax.jit(jog._jadd_formulas)(o["jp"], o["jq"]),
        lambda o: [a + a + b + c for a, b, c in zip(o["A"], o["B"], o["C"])],
    ),
    "jdbl": (
        lambda o: tog._jdbl_formulas(o["tp"]),
        lambda o: jax.jit(jog._jdbl_formulas)(o["jp"]),
        lambda o: [a * Fr(4) for a in o["A"]],
    ),
    "jmadd": (
        lambda o: tog._jmadd_formulas(o["tp"], o["td"]),
        lambda o: jax.jit(jog._jmadd_formulas)(o["jp"], o["jd"]),
        lambda o: [a + a + d for a, d in zip(o["A"], o["D"])],
    ),
}


@pytest.mark.parametrize("body", sorted(BODIES))
def test_plain_formulas_equal_jax_on_every_branch(ragged, body):
    tfn, jfn, host = BODIES[body]
    # the operands are what the branch names say
    tp, tq = tog.jpoints_to_host(ragged["tp"]), tog.jpoints_to_host(ragged["tq"])
    for i, kind in enumerate(KINDS, start=1):
        if kind == "dbl":
            assert tp[i] == tq[i] == ragged["D"][i] and not tp[i].inf
        if kind == "neg":
            assert tp[i] == -tq[i] == -ragged["D"][i] and not tp[i].inf
        assert tp[i].inf == (kind in ("pinf", "both")) and tq[i].inf == (kind in ("qinf", "both"))
    got = tfn(ragged)
    for t, j in zip(got, jfn(ragged)):
        assert np.array_equal(to_reference(t), np.asarray(j))
    assert tog.jpoints_to_host(got) == host(ragged)
