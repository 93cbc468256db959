"""curdleproofs_tpu_torch ops.gather / ops.stream_scan / ops.scan vs the JAX
package's, limb for limb. The JAX side runs through the XLA twins of its
Pallas kernels, as its own tests do on the CPU. Integer equality only."""
import contextlib
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.ops import g1 as jog
from curdleproofs_tpu.ops import gather as jgather
from curdleproofs_tpu.ops import scan as jscan
from curdleproofs_tpu.ops import stream_scan as jstream
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import cuda_g1
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import gather as tgather
from curdleproofs_tpu_torch.ops import scan as tscan
from curdleproofs_tpu_torch.ops import stream_scan as tstream
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, to_reference

# The lanes here are few: intra-op threads add nothing but spin-waiting, which
# slows every worker of a parallel test run many times over.
torch.set_num_threads(1)

W, T, L, S = 2, 8, 32, 16


def _same(t, j):
    return np.array_equal(to_reference(t), np.asarray(j))


@pytest.mark.parametrize("shared", [False, True])
def test_gather_matches_jax_with_out_of_range(shared):
    rng = np.random.default_rng(5)
    R, Wg, N, M = 49, 3, 64, 40
    idx = rng.integers(-2, N + 2, (Wg, M)).astype(np.int32)
    idx[0, :3] = [-1, N, N - 1]
    if shared:
        table = rng.integers(0, 1 << 16, (R, N)).astype(np.uint32)
        got = tgather.gather_u32_shared(from_reference(table, "cpu"), from_reference(idx, "cpu"))
        table3 = np.repeat(table[:, None, :], Wg, axis=1)
    else:
        table3 = rng.integers(0, 1 << 16, (R, Wg, N)).astype(np.uint32)
        got = tgather.gather_u32(from_reference(table3, "cpu"), from_reference(idx, "cpu"))
    want = jgather.gather_u32_xla(jnp.asarray(table3), jnp.asarray(idx))
    assert got.dtype == torch.int32
    assert _same(got, want)
    assert not to_reference(got)[:, 0, :2].any()  # -1 and N gather zeros


def test_gather_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        tgather.gather_u32(torch.zeros((4, 2, 8), dtype=torch.int32), torch.zeros((3, 5), dtype=torch.int32))


@pytest.fixture(scope="module")
def records():
    """(49, W*T*L) records of real curve points with infinity records and,
    in lane 0 of window 0, the same point at steps 0 and 1 (p == q)."""
    rng = random.Random(23)
    n = W * T * L
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]  # distinct
    pts[1 * L + 0] = pts[0 * L + 0]  # window 0, lane 0, steps 0 and 1
    pts[T * L + 3 * L + 5] = G1.identity()  # window 1, step 3, lane 5
    pts[T * L + 6] = G1.identity()  # window 1, step 0, lane 6
    ap = tog.pack_points(pts, "cpu")
    rec = torch.cat([ap.x, ap.y, ap.inf.unsqueeze(0).to(torch.int32)], dim=0)
    return rec, jnp.asarray(to_reference(rec))


def test_scan_records_matches_jax(records, monkeypatch):
    """The unsplit scan (SCAN_SPLIT = 1) is the JAX package's, limb for limb."""
    monkeypatch.setattr(tstream, "SCAN_SPLIT", 1)
    rec, jrec = records
    pref, tot = tstream.scan_records(rec, W, T, L)
    jpref, jtot = jax.jit(jstream._scan_records_xla, static_argnums=(1, 2, 3))(jrec, W, T, L)
    assert tuple(pref.shape) == (72, W, T * L) and tuple(tot.shape) == (72, W, L)
    assert _same(pref, jpref)
    assert _same(tot, jtot)


def _points(t):
    t = t.reshape(72, -1)
    return tog.jpoints_to_host(tog.JPoints(t[:24], t[24:48], t[48:]))


def test_scan_records_default_split_equals_jax_as_points(records):
    """At the default split (K sub-chains a lane) every prefix and total is
    the JAX package's point, as another Jacobian triple."""
    rec, jrec = records
    assert tstream.split_steps(T) > 1
    pref, tot = tstream.scan_records(rec, W, T, L)
    jpref, jtot = jax.jit(jstream._scan_records_xla, static_argnums=(1, 2, 3))(jrec, W, T, L)
    assert _points(pref) == _points(from_reference(np.asarray(jpref), "cpu"))
    assert _points(tot) == _points(from_reference(np.asarray(jtot), "cpu"))


def test_scan_records_sel_matches_jax_with_forced_collision(records):
    rec, jrec = records
    rng = np.random.default_rng(9)
    sel = rng.integers(-1, L, (W * T, S)).astype(np.int32)
    sel[0, :3] = [7, 7, -1]  # a repeated lane and an empty slot
    bsel, tot, flags = tstream.scan_records_sel(rec, from_reference(sel, "cpu"), W, T, L, S, split=1)
    jb, jt, jf = jax.jit(jstream.scan_records_sel, static_argnums=(2, 3, 4, 5))(
        jrec, jnp.asarray(sel), W, T, L, S
    )
    assert tuple(bsel.shape) == (72, W, T * S)
    assert _same(bsel, jb)
    assert _same(tot, jt)
    assert to_reference(flags).tolist() == np.asarray(jf).tolist() == [1, 0]
    assert not to_reference(bsel)[:, 0, 2].any()  # the empty slot is the zero triple


def test_scan_sel_out_of_range_lane_is_empty(records):
    rec, _ = records
    sel = np.full((W * T, S), -1, np.int32)
    sel[:, 0] = L  # past the last lane: an empty slot, as in the kernel
    sel[:, 1] = 4
    bsel, _, _ = tstream.scan_records_sel(rec, from_reference(sel, "cpu"), W, T, L, S, split=1)
    pref, _ = tstream.scan_records(rec, W, T, L, split=1)
    got = to_reference(bsel).reshape(72, W, T, S)
    assert not got[..., 0].any()
    want = to_reference(pref).reshape(72, W, T, L)[..., 4]
    # lane 4 never meets p == q, so the no-doubling prefixes equal the complete ones
    assert np.array_equal(got[..., 1], want)


def test_scan_wrappers_check_shapes(records):
    rec, _ = records
    with pytest.raises(ValueError):
        tstream.scan_records(rec, W, T, L + 1)
    with pytest.raises(ValueError):
        tstream.scan_records_sel(rec, torch.zeros((W * T, S + 1), dtype=torch.int32), W, T, L, S)


def test_pick_lanes(monkeypatch):
    assert tstream.pick_lanes(1 << 17) == jstream.pick_lanes(1 << 17) == 512
    assert tstream.pick_lanes(128) == 128
    monkeypatch.setattr(tstream, "_LANES", 32)
    assert tstream.pick_lanes(1 << 17) == 32 and tstream.pick_lanes(16) == 16


@pytest.fixture(scope="module")
def lane_points():
    rng = random.Random(31)
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(2 * 16)]
    pts[3] = G1.identity()
    pts[20] = pts[21]
    ap = tog.pack_points(pts, "cpu")
    tj = tog.lift(tog.APoints(ap.x.reshape(24, 2, 16), ap.y.reshape(24, 2, 16), ap.inf.reshape(2, 16)))
    jj = jog.JPoints(*(jnp.asarray(to_reference(a)) for a in tj))
    return pts, tj, jj


def test_hs_scan_matches_jax(lane_points):
    pts, tj, jj = lane_points
    got = tscan._hs_scan(tj)
    want = jax.jit(jscan._hs_scan)(jj)
    for t, j in zip(got, want):
        assert _same(t, j)
    host = tog.jpoints_to_host(tog.JPoints(*(a[:, 1] for a in got)))
    acc = G1.identity()
    for i, p in enumerate(pts[16:]):
        acc = acc + p
        assert host[i] == acc


@pytest.mark.parametrize("small_width,width", [(8, 16), (2048, 16), (2048, 13)])
def test_tree_reduce_hybrid_matches_jax(lane_points, monkeypatch, small_width, width):
    """SMALL_WIDTH lowered so a halving level above it runs too; width 13
    exercises the padding."""
    pts, tj, jj = lane_points
    monkeypatch.setattr(tscan, "SMALL_WIDTH", small_width)
    monkeypatch.setattr(jscan, "SMALL_WIDTH", small_width)
    tin = tog.JPoints(*(a[..., :width] for a in tj))
    jin = jog.JPoints(*(a[..., :width] for a in jj))
    got = tscan.tree_reduce_hybrid(tin)
    want = jscan.tree_reduce_hybrid(jin)
    for t, j in zip(got, want):
        assert _same(t, j)
    host = tog.jpoints_to_host(got)
    for w in range(2):
        acc = G1.identity()
        for p in pts[16 * w : 16 * w + width]:
            acc = acc + p
        assert host[w] == acc


# ---------------------------------------------------------------------------
# inclusive_scan_records: the level schedule, its plain twin and its launcher
# ---------------------------------------------------------------------------


def _scan_input(rows, width):
    """(49, rows, width) records and their host points: distinct points, the
    identity at lane 1 of every row, lane 3 the base of lane 2 (a doubling
    inside the scan), and the last row starting with the identity."""
    step = G1() * Fr(0x5EED)
    acc, pts = G1() * Fr(77), []
    for _ in range(rows * width):
        acc = acc + step
        pts.append(acc)
    grid = [pts[r * width : (r + 1) * width] for r in range(rows)]
    for row in grid:
        if width > 1:
            row[1] = G1.identity()
        if width > 3:
            row[3] = row[2]
    grid[-1][0] = G1.identity()
    flat = [p for row in grid for p in row]
    ap = tog.pack_points(flat, "cpu")
    rec = torch.cat([ap.x, ap.y, ap.inf.unsqueeze(0).to(torch.int32)], dim=0)
    return rec.reshape(49, rows, width), grid


SCAN_CASES = [(8, 4, 1), (8, 2048, 3), (64, 4, 3), (64, 2048, 8), (256, 4, 8), (256, 2048, 1), (1, 4, 3), (2, 4, 1),
              (8, 1, 3)]


@pytest.mark.parametrize("width,small,rows", SCAN_CASES)
def test_levels_ref_equals_scan_records(monkeypatch, width, small, rows):
    """The plain twin of the card's level schedule against the CPU path of
    `inclusive_scan_records` (lift, `inclusive_scan`, concatenation),
    coordinate for coordinate, and every prefix against the host. SMALL_WIDTH
    4 puts zero to six levels above the fixed-width scan, 2048 none, 1 three
    above a width of one."""
    monkeypatch.setattr(tscan, "SMALL_WIDTH", small)
    g, grid = _scan_input(rows, width)
    want = tscan.inclusive_scan_records(g)
    got = tscan.inclusive_scan_levels_ref(g)
    assert tuple(got.shape) == (72, rows, width)
    assert torch.equal(got, want)
    for r, row in enumerate(grid):
        host = tog.jpoints_to_host(tog.JPoints(got[:24, r], got[24:48, r], got[48:, r]))
        acc = G1.identity()
        for i, p in enumerate(row):
            acc = acc + p
            assert host[i] == acc, f"row {r} prefix {i}"


def _columns(op, lanes):
    return {op.off + op.step * j for j in range(op.lo, lanes)}


def _paired(a, b):
    """b is the column after a at step 2, from an even column: one 8-byte
    pair a lane on the card."""
    return a.buf == b.buf and a.step == b.step == 2 and b.off == a.off + 1 and a.off % 2 == 0 and a.lo == b.lo == 0


@pytest.mark.parametrize("n,small", [(1, 4), (2, 4), (8, 4), (64, 4), (256, 8), (256, 2048), (1 << 12, 2048),
                                     (2, 1), (8, 1), (32, 2)])
def test_scan_schedule_shape(n, small):
    """`inclusive_scan`'s launches: K levels up, the fixed-width steps, K
    down. No launch writes a column it reads, every column lies inside its
    buffer, and each column of the table is written once. Every launch
    names the card's body whose layout it has (csrc/kernels.cu,
    `body_fits`): a level up (UP) reads columns 2j and 2j + 1 as a pair, a
    level down (DOWN) copies the prefix its p reads at j + 1 and stores both
    columns as a pair, a fixed-width step (ANY) copies nothing; the scratch
    is even."""
    cols, launches = tscan.scan_schedule(n, small)
    assert cols % 2 == 0
    K = max(0, n.bit_length() - 1 - (small.bit_length() - 1))
    steps = max(1, ((n >> K) - 1).bit_length())
    assert [s.kind for s in launches] == [tscan.UP] * K + [tscan.ANY] * steps + [tscan.DOWN] * K
    for step in launches:
        if step.kind == tscan.DOWN:
            p, c = step.p, step.copy
            assert p.buf == c.buf and p.step == c.step == 1 and c.off == p.off + 1 and (p.lo, c.lo) == (1, 0)
            assert step.q.step == 2 and step.q.off % 2 == 0 and step.q.lo == 0
            assert _paired(step.out, step.copy_out)
        else:
            assert step.copy is None and step.copy_out is None
        if step.kind == tscan.UP:
            assert _paired(step.p, step.q)
    width = {tscan.RECORDS: n, tscan.SCRATCH: cols, tscan.TABLE: n}
    table = []
    for step in launches:
        reads = [step.p, step.q] + ([step.copy] if step.copy else [])
        writes = [step.out] + ([step.copy_out] if step.copy_out else [])
        for op in reads + writes:
            assert all(0 <= c < width[op.buf] for c in _columns(op, step.lanes)), step
        for w in writes:
            assert w.buf != tscan.RECORDS and w.lo == 0
            for r in reads:
                assert r.buf != w.buf or not _columns(r, step.lanes) & _columns(w, step.lanes), step
            if w.buf == tscan.TABLE:
                table += sorted(_columns(w, step.lanes))
    assert sorted(table) == list(range(n))
    with pytest.raises(ValueError):
        tscan.scan_schedule(12, small)


def test_scan_schedule_at_the_benchmark_shape():
    """2^19 lanes above 2048: 8 levels up, 11 steps, 8 down."""
    cols, launches = tscan.scan_schedule(1 << 19, 2048)
    assert len(launches) == 27
    assert cols == (1 << 19) - 2048 + 2 * 2048 + (1 << 18) + (1 << 17)


def test_scan_records_refuses_other_widths():
    with pytest.raises(ValueError):
        tscan.inclusive_scan_records(torch.zeros((49, 1, 12), dtype=torch.int32))
    with pytest.raises(ValueError):
        tscan.inclusive_scan_levels_ref(torch.zeros((72, 1, 8), dtype=torch.int32))


def _strided_stand_in(calls):
    """`curdle_point_strided` on the host: reads the view words the wrapper
    packed, finds every operand by address as the kernel does, and runs the
    plain complete add."""
    import ctypes

    def run(views, kind, lanes, rows, group, blocks, stream):
        w = np.ctypeslib.as_array((ctypes.c_longlong * 35).from_address(views.value)).reshape(5, 7).tolist()
        calls.append((lanes, rows, group, blocks, kind))
        assert blocks * cuda_g1.POINT_THREADS >= lanes * rows * group

        def addr(v, nrows):
            base, limb, row, off, step, lo, _ = v
            idx = (np.arange(nrows)[:, None, None] * limb + np.arange(rows)[None, :, None] * row + off
                   + np.maximum(np.arange(lanes), lo)[None, None, :] * step)
            assert idx.min() >= 0
            mem = np.ctypeslib.as_array((ctypes.c_int32 * (int(idx.max()) + 1)).from_address(base))
            return mem, idx

        def read(v):
            mem, idx = addr(v, 49 if v[6] else 72)
            t = torch.from_numpy(mem[idx].copy())
            p = tog.lift(tog.APoints(t[:24], t[24:48], t[48] != 0)) if v[6] else tog.JPoints(t[:24], t[24:48], t[48:])
            keep = torch.arange(lanes) >= v[5]
            return tog.jselect(keep, p, tog.jinf(p.x.shape[1:]))

        def write(v, p):
            mem, idx = addr(v, 72)
            mem[idx] = torch.cat([p.x, p.y, p.z]).numpy()

        p, q, out, copy, copy_out = w
        write(out, tog._jadd_formulas(read(p), read(q)))
        if copy[0]:
            write(copy_out, read(copy))
        return 0

    return run


@pytest.mark.parametrize("width,small,rows", [(64, 4, 3), (256, 2048, 1)])
def test_point_strided_launcher_decodes_to_the_twin(monkeypatch, width, small, rows):
    """The card's launcher (`cuda_g1.point_strided`) on CPU buffers against a
    stand-in library that reads its view words as the kernel does: the
    schedule it enqueues is the twin's, bit for bit, at the picked groups."""
    monkeypatch.setattr(tscan, "SMALL_WIDTH", small)
    calls = []
    monkeypatch.setattr(cuda_g1, "lib", lambda: types.SimpleNamespace(curdle_point_strided=_strided_stand_in(calls)))
    monkeypatch.setattr(cuda_g1, "check_tensor", lambda name, t, shape, dtype=torch.int32: None)
    monkeypatch.setattr(cuda_g1, "stream_ptr", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setitem(cuda_g1.launch_counts, "point_strided", 0)
    g, _ = _scan_input(rows, width)
    got = tscan._run_schedule(g, cuda_g1.point_strided)
    assert torch.equal(got, tscan.inclusive_scan_levels_ref(g))
    launches = tscan.scan_schedule(width, small)[1]
    assert cuda_g1.launch_counts["point_strided"] == len(calls) == len(launches)
    assert [c[2] for c in calls] == [cuda_g1.point_group(rows * s.lanes, "jadd") for s in launches]
    assert [c[4] for c in calls] == [s.kind for s in launches]


def test_point_strided_refuses_a_write_outside_its_buffer(monkeypatch):
    monkeypatch.setattr(cuda_g1, "check_tensor", lambda name, t, shape, dtype=torch.int32: None)
    bufs = (torch.zeros((49, 1, 8), dtype=torch.int32), torch.zeros((72, 1, 4), dtype=torch.int32),
            torch.zeros((72, 1, 8), dtype=torch.int32))
    R, S = tscan.RECORDS, tscan.SCRATCH
    step = tscan.Launch(4, tscan.Operand(R, 0, 2), tscan.Operand(R, 1, 2), tscan.Operand(S, 1))
    with pytest.raises(ValueError):
        cuda_g1._view_words(bufs, step.out, step.lanes)
    with pytest.raises(ValueError):
        cuda_g1.point_strided(bufs, step._replace(out=tscan.Operand(R, 0)))
