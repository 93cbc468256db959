"""The port's multi-device MSM (curdleproofs_tpu_torch.parallel) in gloo
worlds of 1, 2 and 4 processes on the CPU, against the host oracle and the
JAX package's sharded MSMs on its 8 virtual CPU devices (tests/conftest.py).

Each world size is one spawned world that runs every case its tests read
(`_rank_job`); the three worlds run side by side while this process computes
the JAX side. A world that hangs fails at its join timeout, and its
processes are stopped. Every comparison is exact.

The JAX package is imported inside the tests: the ranks import this module
by name, and they import neither jax nor the JAX package."""
import concurrent.futures
import contextlib
import functools
import random

import numpy as np
import pytest
import torch

from curdleproofs_tpu_torch.curve import G1, msm_host
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import msm as tmsm
from curdleproofs_tpu_torch.ops.g1 import JPoints, jpoints_to_host
from curdleproofs_tpu_torch.ops import stream_scan as tstream
from curdleproofs_tpu_torch.ops.fieldspec import to_reference
from curdleproofs_tpu_torch.parallel import distributed, make_mesh, make_mesh_2d
from curdleproofs_tpu_torch.parallel import msm as pmsm
from curdleproofs_tpu_torch.parallel.dryrun import dryrun_multichip
from curdleproofs_tpu_torch.utils import host_native
from curdleproofs_tpu_torch.utils.profiling import metrics

torch.set_num_threads(1)

WORLD_TIMEOUT_S = 300
ENGINES = ("sharded", "ladder", "stream")


def _rand_inputs(n, seed):
    rng = random.Random(seed)
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]
    scs = [Fr(rng.randrange(FR_MOD)) for _ in range(n)]
    return pts, scs


@functools.lru_cache(maxsize=None)
def _inputs():
    """The entry points' inputs, the same at every world size: the largest
    shapes of tests/test_sharded.py (n = 96 at c = 4; 16*4 + 3; 32*4 + 5 at
    c = 4), each with an identity base and a zero scalar; and the sel-path
    inputs (n = 120*d at c = 8, with the selection taking over from 64
    lanes a rank and 32 scan lanes, as the JAX package's sel test patches
    it), among them one rank's block of equal bases and scalars (a doubling
    collision)."""
    out = {}
    pts, scs = _rand_inputs(96, 1)
    pts[0], scs[1] = G1.identity(), Fr(0)
    out["sharded"] = (pts, scs)
    pts, scs = _rand_inputs(67, 2)
    pts[-1], scs[-1] = G1.identity(), Fr(0)
    out["ladder"] = (pts, scs)
    pts, scs = _rand_inputs(133, 3)
    pts[2], scs[3] = G1.identity(), Fr(0)
    out["stream"] = (pts, scs)
    for d in (2, 4):
        pts, scs = _rand_inputs(120 * d, 10 + d)
        pts[0], scs[1] = G1.identity(), Fr(0)
        out[f"sel{d}"] = (pts, scs)
    pts, scs = out["sel2"]
    out["collision"] = ([pts[5]] * 128 + pts[128:], [Fr(7)] * 128 + scs[128:])
    return out


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _spans():
    return {k: v["calls"] for k, v in metrics().report().items() if k.startswith("msm.sharded")}


def _run(fn, *args, **kw):
    """fn's result, the window sums the group all-reduce handed back (72, W)
    and the agreements this rank took part in, (its flag, the agreed one)."""
    sums, agreed = [], []
    all_reduce, agree = pmsm._allreduce_group, pmsm._agree

    def record_sums(p, group):
        out = all_reduce(p, group)
        sums.append(to_reference(torch.cat([out.x, out.y, out.z])))
        return out

    def record_agree(flag, mesh, axis):
        out = agree(flag, mesh, axis)
        agreed.append((flag, out))
        return out

    metrics().reset()
    with _patched(pmsm, "_allreduce_group", record_sums), _patched(pmsm, "_agree", record_agree):
        got = fn(*args, **kw)
    return {"result": got, "sums": sums, "agreed": agreed, "spans": _spans()}


def _sel_run(mesh, pts, scs, overflow_rank=None):
    """The stream entry point with the selection from 64 lanes a rank and 32
    scan lanes; on overflow_rank the native prep reports that no slot option
    fits."""
    prep = host_native.msm_prep_batch

    def overflowing(*a):
        neg, ocm, bidx, lidx, _, _, _ = prep(*a)
        return neg, ocm, bidx, lidx, None, None, 0

    with contextlib.ExitStack() as st:
        st.enter_context(_patched(tmsm, "SEL_MIN_N", 64))
        st.enter_context(_patched(tstream, "_LANES", 32))
        if overflow_rank == torch.distributed.get_rank():
            st.enter_context(_patched(host_native, "msm_prep_batch", overflowing))
        return _run(pmsm.msm_sharded_stream, pts, scs, mesh=mesh, c=8)


def _rank_job(d, inputs):
    """Everything one rank of a world of d runs."""
    mesh = make_mesh(device="cpu")
    out = {"coords": mesh.coords, "shape": mesh.shape}
    pts, scs = inputs["sharded"]
    out["sharded"] = _run(pmsm.msm_sharded, pts, scs, mesh=mesh, c=4)
    pts, scs = inputs["ladder"]
    out["ladder"] = _run(pmsm.msm_sharded_ladder, pts, scs, mesh=mesh)
    pts, scs = inputs["stream"]
    with _patched(tstream, "SCAN_SPLIT", 1):  # the JAX package's scan, triple for triple
        out["stream"] = _run(pmsm.msm_sharded_stream, pts, scs, mesh=mesh, c=4)
    if d == 1:
        pts, scs = inputs["sharded"]
        out["chunks"] = _run(pmsm.msm_sharded, pts, scs, mesh=mesh, c=4, window_batch=24)
    if d > 1:
        out["sel"] = _sel_run(mesh, *inputs[f"sel{d}"])
    if d == 2:
        out["overflow"] = _sel_run(mesh, *inputs["sel2"], overflow_rank=1)
        out["collision"] = _sel_run(mesh, *inputs["collision"])
        with _patched(host_native, "available", lambda: False):
            out["sel_numpy"] = _sel_run(mesh, *inputs["sel2"])
        try:
            make_mesh(1, device="cpu")
        except ValueError as e:
            out["make_mesh_1"] = str(e)
    if d == 4:
        pts, scs = inputs["stream"]
        with _patched(tmsm, "STREAM_SPLIT", 32):  # 133 points: slices of 128 and of 5
            out["split"] = _run(pmsm.msm_sharded_stream, pts, scs, mesh=mesh)
        dryrun_multichip(4, device="cpu")
        out["dryrun"] = "passed"
    return out


# ---------------------------------------------------------------------------
# the worlds and the JAX side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds():
    """d -> a future of the d ranks' results; the three worlds start at once."""
    host_native.lib()  # built here, so the ranks only load it
    inputs = _inputs()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    futs = {
        d: pool.submit(distributed.spawn, _rank_job, d, (d, inputs), timeout=WORLD_TIMEOUT_S)
        for d in (1, 2, 4)
    }
    yield futs
    pool.shutdown(wait=True)


def _world(worlds, d):
    return worlds[d].result()


def _jax_pts(pts):
    from curdleproofs_tpu.curve import G1 as JG1

    return [JG1.identity() if p.inf else JG1(p.x, p.y) for p in pts]


def _same_point(t, j) -> bool:
    return (t.inf and j.inf) or (not t.inf and not j.inf and (t.x, t.y) == (j.x, j.y))


@pytest.fixture(scope="module")
def jax_ref(worlds):
    """The JAX package's three sharded MSMs over its mesh of 2 on the same
    inputs, and the window sums its shard kernels returned (72, W)."""
    from curdleproofs_tpu.fields import Fr as JFr
    from curdleproofs_tpu.parallel import msm as jpmsm
    from curdleproofs_tpu.parallel.mesh import make_mesh as jmake_mesh

    sums = {}

    def spy(name, key):
        orig = getattr(jpmsm, name)

        def build(*a):
            f = orig(*a)

            def call(*args):
                out = f(*args)
                sums[key] = np.concatenate([np.asarray(o) for o in out[:3]])
                return out

            return call

        return build

    mesh = jmake_mesh(2)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jpmsm, "_pippenger_shard_fn", spy("_pippenger_shard_fn", "sharded"))
        mp.setattr(jpmsm, "_stream_shard_fn", spy("_stream_shard_fn", "stream"))
        calls = {
            "sharded": lambda p, s: jpmsm.msm_sharded(p, s, mesh=mesh, c=4),
            "ladder": lambda p, s: jpmsm.msm_sharded_ladder(p, s, mesh=mesh),
            "stream": lambda p, s: jpmsm.msm_sharded_stream(p, s, mesh=mesh, c=4),
        }
        for name, call in calls.items():
            pts, scs = _inputs()[name]
            out[name] = call(_jax_pts(pts), [JFr(s.v) for s in scs])
    finally:
        mp.undo()
    return {"results": out, "sums": sums}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_msm_equals_jax(worlds, jax_ref, engine):
    """The port's world of 2 against the JAX package's mesh of 2."""
    got = _world(worlds, 2)[0][engine]["result"]
    assert _same_point(got, jax_ref["results"][engine])


@pytest.mark.parametrize("engine", ["sharded", "stream"])
def test_window_sums_equal_jax_limb_for_limb(worlds, jax_ref, engine):
    """The window sums after the group all-reduce, (72, W) Jacobian limbs, on
    every rank of the world of 2, equal the JAX package's shard kernel's
    output (`_pippenger_shard_fn`, `_stream_shard_fn`) limb for limb: the
    same formulas, in the same order, on the same blocks (the stream engine's
    scan unsplit, SCAN_SPLIT = 1)."""
    want = jax_ref["sums"][engine]
    for r in _world(worlds, 2):
        (got,) = r[engine]["sums"]
        assert got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_msm_equals_oracle_on_every_rank(worlds, d, engine):
    """Every rank returns msm_host's point, at every world size: the result
    does not depend on how the points are sharded."""
    ranks = _world(worlds, d)
    pts, scs = _inputs()[engine]
    want = msm_host(pts, scs)
    assert [r[engine]["result"] for r in ranks] == [want] * d
    assert [r["coords"] for r in ranks] == [{"shard": k} for k in range(d)]


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_stream_sel_path_engages(worlds, d):
    """The port's counterpart of the JAX package's
    test_sharded_stream_sel_production_path: with the selection from 64
    lanes a rank, every rank runs the sel path (the native prep, the scan
    with in-step boundary selection) and not the plain one, and the result is
    the oracle's."""
    pts, scs = _inputs()[f"sel{d}"]
    want = msm_host(pts, scs)
    for r in _world(worlds, d):
        run = r["sel"]
        assert run["result"] == want
        assert run["spans"].get("msm.sharded.sel") == 1
        assert "msm.sharded.plain" not in run["spans"]
        assert run["agreed"] == [(False, False), (False, False)]
        assert run["spans"].get("msm.sharded.host_prep.native") == 1


def test_sharded_stream_sel_path_engages_on_the_numpy_prep(worlds):
    """Without the native host library the sharded engine still takes the sel
    path, on the numpy prep, as msm() does (both call ops.msm.stream_prep),
    on every rank of the world of 2."""
    pts, scs = _inputs()["sel2"]
    want = msm_host(pts, scs)
    for r in _world(worlds, 2):
        run = r["sel_numpy"]
        assert run["result"] == want
        assert run["spans"].get("msm.sharded.sel") == 1
        assert run["spans"].get("msm.sharded.host_prep.numpy") == 1
        assert "msm.sharded.host_prep.native" not in run["spans"]
        assert "msm.sharded.plain" not in run["spans"]


@pytest.mark.parametrize("case,rank", [("overflow", 1), ("collision", 0)])
def test_one_rank_sends_every_rank_to_the_plain_path(worlds, case, rank):
    """A selection-slot overflow on rank 1 only, and a doubling collision
    (a block of equal bases and scalars) on rank 0 only: every rank agrees,
    takes the plain path, and returns the oracle's point."""
    pts, scs = _inputs()["collision" if case == "collision" else "sel2"]
    want = msm_host(pts, scs)
    ranks = _world(worlds, 2)
    for k, r in enumerate(ranks):
        run = r[case]
        assert run["result"] == want
        assert run["spans"].get("msm.sharded.sel") == 1 and run["spans"].get("msm.sharded.plain") == 1
        flags = [f for f, _ in run["agreed"]]
        assert run["agreed"][-1][1] is True
        # the overflow agreement is the first, the doubling flag the second
        assert flags[0 if case == "overflow" else 1] == (k == rank)
    assert len(ranks[0][case]["agreed"]) == (1 if case == "overflow" else 2)


def test_make_mesh_takes_the_whole_world(worlds):
    """make_mesh(n) needs n == the world size (the JAX package can take the
    first n of a host's devices), alone and in a world of 2."""
    assert "world has 2 processes" in _world(worlds, 2)[0]["make_mesh_1"]
    with pytest.raises(ValueError, match="world has 1 processes"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="world has 1 processes"):
        make_mesh_2d((2, 2), ("dp", "sp"), device="cpu")
    with pytest.raises(ValueError, match="make_mesh_2d"):
        make_mesh(1, ("dp", "sp"), device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.coords, mesh.groups) == ({"shard": 1}, {"shard": 0}, {"shard": None})


def test_window_chunks_each_take_their_own_total(worlds):
    """msm_sharded in chunks of 24 of its 64 windows (the last one short):
    each chunk's boundary sums with its own scan total (another Jacobian
    triple of the same point), so the window sums are the same points as in
    one chunk."""
    pts, scs = _inputs()["sharded"]
    (r,) = _world(worlds, 1)
    assert r["chunks"]["result"] == msm_host(pts, scs)

    def points(a):
        return jpoints_to_host(JPoints(a[:24], a[24:48], a[48:]))

    assert points(r["chunks"]["sums"][0]) == points(r["sharded"]["sums"][0])


def test_sharded_stream_walks_the_same_slices_on_every_rank(worlds):
    """Wider than D * STREAM_SPLIT: every rank runs the same slices (here
    128 and 5 points over 4 ranks), each at its own window size, and returns
    their sum."""
    pts, scs = _inputs()["stream"]
    want = msm_host(pts, scs)
    for r in _world(worlds, 4):
        assert r["split"]["result"] == want
        assert r["split"]["spans"]["msm.sharded_stream"] == 2


def test_dryrun_multichip_in_a_world_of_4(worlds):
    """dryrun_multichip(4): the three engines on a mesh of 4 and the batched
    (2, 2) dp x sp layout, against the oracle, on every rank."""
    assert [r["dryrun"] for r in _world(worlds, 4)] == ["passed"] * 4


def test_sharded_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pts, scs = [G1()] * 3, [Fr(2)] * 3
    for fn in (pmsm.msm_sharded, pmsm.msm_sharded_ladder, pmsm.msm_sharded_stream):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(pts, scs)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize("localhost:1", num_processes=2, process_id=0)
    assert pmsm.msm_sharded(pts, scs, device="cpu") == G1() * Fr(6)


def _sleep_forever():
    import time

    while True:
        time.sleep(1)


def _raise():
    raise KeyError("rank failure")


def test_spawn_stops_a_world_that_hangs_or_fails():
    """A world past its timeout raises and its processes are stopped; a rank
    that raises fails the world with its traceback."""
    with pytest.raises(TimeoutError, match="still running"):
        distributed.spawn(_sleep_forever, 2, timeout=5)
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="KeyError: 'rank failure'"):
        distributed.spawn(_raise, 2, timeout=120)
