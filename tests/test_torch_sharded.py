"""The port's multi-rank serving against the JAX package, on the CPU.

Ranks are processes (``torch.multiprocessing``, spawn) in gloo groups of 2
and 4, started once for the module (tests/test_torch_ranks.py); the layouts
(query, index) are (2, 1) and (1, 2) on two ranks, (2, 2) and (1, 4) on
four. Every rank makes the same call and must return the same dict. The
indexes are the reference parity tests' (tests/test_sharded_parity.py,
tests/test_index_sharded_parity.py): grid layouts of ``fs`` at n = 1,500
and 2,500, built by both packages.

* query-parallel ``serve_sharded`` / ``serve_knn_sharded``: every key and
  ``frontier_widths`` equal the reference's single-device ``retrieve`` /
  ``retrieve_knn`` with a fresh ``PlanCache`` (kNN ``dist2`` to 1 ulp: the
  reference's jitted distances are FMA-contracted on the CPU, ROADMAP §C;
  bit for bit against the port's own single-device path), through ragged
  batches, width growth from a cold cache and ``max_leaves`` overflow;
* index-parallel ``serve_index_sharded``: the counters and each query's id
  set equal; ``serve_knn_index_sharded``: ids, ``dist2`` and every counter;
* both regimes with a live delta (inserts, base and buffered deletes), and
  at six non-finite MIX queries (``with_nonfinite``);
* one exact layout: the reference's ``serve_index_sharded`` /
  ``serve_knn_index_sharded`` on a forced 4-device host platform (a
  subprocess) equal the port's (1, 4) run array for array -- id order,
  ``nodes_scanned`` and ``frontier_widths`` included -- with and without a
  delta;
* ``LiveIndex(index_shards=2)`` over the port's own build: the same
  serves, kNN batches, inserts, deletes and a forced swap as the port's
  single-device ``LiveIndex``, equal step for step;
* the flat fallback step on two ranks and on one equals the reference's
  step over the same leaf shards, and the port's plain per-shard sum;
* the replica memo keeps nothing alive that the caller dropped;
* the indexed kNN leaf phase's rank of a key is the reference's count of
  smaller keys, NaN and inf keys included, without an (M, F, S*F) compare
  (a shape where that compare would take 8.6 GB runs in under 256 MB).
"""
import gc
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.serve import delta as jdelta, engine as jengine  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro_torch.core.build import build_wisk  # noqa: E402
from repro_torch.core.drift import DriftConfig  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.flat_legacy import OBJ_PER_LEAF, TOP_LEAVES_LOCAL, wisk_serve_step  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.launch.wisk_serve import LiveIndex, _replicated  # noqa: E402
from repro_torch.serve.delta import DeltaLog  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, _global_rank, retrieve, retrieve_knn  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402
from repro_torch.serve.snapshot import PartitionedSnapshot  # noqa: E402

from test_torch_build import port_config  # noqa: E402
from test_torch_cases import with_nonfinite  # noqa: E402
from test_torch_ranks import RankPool, run_live_steps  # noqa: E402
from test_torch_serving import _pair  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SKR_EXACT = ("counts", "nodes_checked", "verified", "overflow")
SKR_KEYS = ("ids", "counts", "nodes_checked", "nodes_scanned", "verified", "overflow",
            "frontier_widths")
KNN_KEYS = ("ids", "dist2", "nodes_checked", "verified", "leaves_verified", "pruned")
LAYOUTS = [(2, 1), (1, 2), (2, 2), (1, 4)]


# ------------------------------------------------------------------ ranks
@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    d = tmp_path_factory.mktemp("rendezvous")
    made = {w: RankPool(w, f"file://{d}/world{w}") for w in (2, 4)}
    yield made
    for p in made.values():
        p.close()


def _run(pools, layout, task, *args):
    """``task`` on the pool of ``query * index`` ranks; every rank's result
    must be the same (the whole batch's dict on every rank)."""
    outs = pools[layout[0] * layout[1]].run(task, layout, *args)
    for other in outs[1:]:
        _same_results(other, outs[0])
    return outs[0]


def _same_results(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_results(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_results(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


# --------------------------------------------------------------- fixtures
def _points(rects):
    return np.stack([(rects[:, 0] + rects[:, 2]) / 2, (rects[:, 1] + rects[:, 3]) / 2],
                    1).astype(np.float32)


class Case:
    """One grid index built by both packages, a workload, the port's
    snapshot and partitions, and the reference's single-device outputs."""

    def __init__(self, n, seed, g, levels, m, wl_seed, **wl_kw):
        self.index, self.ds, jindex, jds = _pair("grid", "fs", n, seed, g=g, levels=levels)
        self.K = self.index.levels[-1].n
        self.wl = make_workload(self.ds, m=m, seed=wl_seed, **wl_kw)
        jwl = jmake_workload(jds, m=m, seed=wl_seed, **wl_kw)
        np.testing.assert_array_equal(self.wl.rects, jwl.rects)
        self.rects, self.bms, self.m = self.wl.rects, self.wl.kw_bitmap, m
        self.points = _points(self.rects)
        self.snap = IndexSnapshot.build(self.index, self.ds, device="cpu")
        self.jindex, self.jds = jindex, jds
        self.jsnap = jengine.IndexSnapshot.build(jindex, jds)
        self._parts = {}

    def psnap(self, S):
        if S not in self._parts:
            self._parts[S] = PartitionedSnapshot.build(self.snap, S)
        return self._parts[S]

    def ref_skr(self, max_leaves, delta=None):
        return jengine.retrieve(self.jsnap, self.rects, self.bms, max_leaves,
                                plan_cache=JPlanCache(), delta=delta)

    def ref_knn(self, k, delta=None):
        return jengine.retrieve_knn(self.jsnap, self.points, self.bms, k,
                                    plan_cache=JPlanCache(), delta=delta)


@pytest.fixture(scope="module")
def case_a():
    """tests/test_index_sharded_parity.py's ``_fixture()``: ragged 13-query
    MIX batch, two levels."""
    c = Case(1500, 0, 6, 2, 13, 10, dist="MIX")
    c.skr, c.knn5, c.knn1 = c.ref_skr(c.K), c.ref_knn(5), c.ref_knn(1)
    return c


@pytest.fixture(scope="module")
def case_b():
    """Wide UNI queries on three levels: width growth from a cold cache,
    and ``max_leaves=2`` spills."""
    c = Case(2500, 5, 8, 3, 16, 9, dist="UNI", region_frac=0.2, n_keywords=4)
    c.skr2, c.skr = c.ref_skr(2), c.ref_skr(c.K)
    assert c.skr2["overflow"].sum() > 0
    return c


def _updated(ds, index, snap, log_cls, seed=7, n_ins=40, n_del=30, jitter=0.05):
    """tests/test_delta_maintenance.py's ``_updated_log``: jittered-copy
    inserts, then base and buffered deletes."""
    log = log_cls(index, ds, snap)
    rng = np.random.default_rng(seed)
    src = rng.choice(ds.n, n_ins)
    locs = np.clip(ds.locs[src] + rng.normal(0, jitter, (n_ins, 2)).astype(np.float32), 0, 1)
    new_ids = log.insert(locs, ds.kw_ids[src])
    log.delete(list(rng.choice(ds.n, n_del, replace=False)) + [int(new_ids[0]), int(new_ids[-1])])
    return log


@pytest.fixture(scope="module")
def case_d():
    """A live delta over the reference tests' delta fixture (n = 1500,
    seed 1, workload seed 7)."""
    c = Case(1500, 1, 6, 2, 13, 7, dist="MIX")
    c.log = _updated(c.ds, c.index, c.snap, DeltaLog)
    c.jlog = _updated(c.jds, c.jindex, c.jsnap, jdelta.DeltaLog)
    c.skr, c.knn5 = c.ref_skr(c.K), c.ref_knn(5)
    c.dskr, c.dknn5 = c.ref_skr(c.K, c.jlog.buffer), c.ref_knn(5, c.jlog.buffer)
    return c


@pytest.fixture(scope="module", autouse=True)
def forced_reference(tmp_path_factory):
    """The reference's index-parallel front doors on a forced 4-device host
    platform, in a subprocess started with the module's first test and read
    when a test needs it."""
    out = tmp_path_factory.mktemp("forced") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} --xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.Popen([sys.executable, "-c", _FORCED, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _finished(forced):
    """The subprocess's output, once it has ended well."""
    proc, out = forced
    if proc.returncode is None:
        try:
            _, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, err[-4000:]
    assert proc.returncode == 0
    return out


_FORCED = r"""
import sys
import numpy as np
import jax
from repro.data.synth import make_dataset
from repro.data.workloads import make_workload
from repro.launch.mesh import make_serving_mesh
from repro.launch.wisk_serve import serve_index_sharded, serve_knn_index_sharded
from repro.serve.engine import IndexSnapshot
from repro.serve.plan import PlanCache
from repro.serve.snapshot import PartitionedSnapshot
from test_delta_maintenance import _updated_log
from test_query_parity import _build_index

assert len(jax.devices()) == 4, jax.devices()
ds = make_dataset("fs", n=1500, seed=1)
index, clusters = _build_index(ds, g=6, levels=2)
snap = IndexSnapshot.build(index, ds)
wl = make_workload(ds, m=13, dist="MIX", seed=7)
pts = np.stack([(wl.rects[:, 0] + wl.rects[:, 2]) / 2,
                (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1).astype(np.float32)
log = _updated_log(ds, index, snap, seed=7)
psnap = PartitionedSnapshot.build(snap, 4)
mesh = make_serving_mesh(query=1, index=4)
res = {}
for tag, d in (("plain", None), ("delta", log.buffer)):
    o = serve_index_sharded(psnap, wl.rects, wl.kw_bitmap, max_leaves=clusters.k, mesh=mesh,
                            plan_cache=PlanCache(), delta=d)
    res.update({f"skr_{tag}_{k}": np.asarray(v) for k, v in o.items()})
    o = serve_knn_index_sharded(psnap, pts, wl.kw_bitmap, 5, mesh=mesh, plan_cache=PlanCache(),
                                delta=d)
    res.update({f"knn_{tag}_{k}": np.asarray(v) for k, v in o.items()})
np.savez(sys.argv[1], **res)

"""


# ----------------------------------------------------------------- checks
def _sorted_ids(row):
    return np.sort(row[row >= 0])


def _skr_same_sets(got, want, m):
    for k in SKR_EXACT:
        np.testing.assert_array_equal(got[k], np.asarray(want[k])[:m], err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k
    for q in range(m):
        np.testing.assert_array_equal(_sorted_ids(got["ids"][q]),
                                      _sorted_ids(np.asarray(want["ids"][q])), err_msg=f"q{q}")


def _same_keys(got, want, keys, ulp=()):
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        if k in ulp:
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _knn_same(got, want_ref, want_port):
    """ids and counters equal the reference, ``dist2`` to 1 ulp; every key
    bit for bit against the port's own single-device path."""
    _same_keys(got, want_ref, KNN_KEYS, ulp=("dist2",))
    _same_keys(got, want_port, KNN_KEYS + ("frontier_widths",))


def _serve(pools, layout, front_door, args, kw=None, repeat=1):
    outs, widths = _run(pools, layout, "serve", front_door, args, kw or {}, repeat)
    return outs, widths


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_places_ranks_row_major(pools, layout):
    infos = pools[layout[0] * layout[1]].run("mesh_info", layout)
    for r, info in enumerate(infos):
        assert info["rank"] == r
        assert info["shape"] == {"data": layout[0], "index": layout[1]}
        assert info["coords"] == {"data": r // layout[1], "index": r % layout[1]}
    assert pools[layout[0] * layout[1]].run("agree", layout, [3] * 4) == [None] * len(infos)
    msgs = pools[layout[0] * layout[1]].run("agree", layout, list(range(4)))
    assert all("disagree" in m for m in msgs)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_query_parallel_skr_matches_reference(pools, case_a, case_b, layout):
    """Every key, id order and ``frontier_widths`` included, from a cold
    cache and again warm; ragged, growing and spilling batches."""
    (first, again), widths = _serve(pools, layout, "serve_sharded",
                                    (case_a.snap, case_a.rects, case_a.bms, case_a.K), repeat=2)
    _same_keys(first, case_a.skr, SKR_KEYS)
    _same_keys(again, case_a.skr, SKR_KEYS)
    for max_leaves, want in ((2, case_b.skr2), (case_b.K, case_b.skr)):
        (got,), widths = _serve(pools, layout, "serve_sharded",
                                (case_b.snap, case_b.rects, case_b.bms, max_leaves))
        _same_keys(got, want, SKR_KEYS)
        assert tuple(widths[("skr", li)] for li in range(2)) == tuple(want["frontier_widths"][1:])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_query_parallel_knn_matches_reference(pools, case_a, case_b, layout):
    for k, want in ((5, case_a.knn5), (1, case_a.knn1)):
        (got,), _ = _serve(pools, layout, "serve_knn_sharded",
                           (case_a.snap, case_a.points, case_a.bms, k))
        port = retrieve_knn(case_a.snap, case_a.points, case_a.bms, k, plan_cache=PlanCache())
        _knn_same(got, want, port)
        _same_keys(got, want, ("frontier_widths",))
    (got,), _ = _serve(pools, layout, "serve_knn_sharded",
                       (case_a.snap, case_a.points, case_a.bms, 0))
    assert got["ids"].shape == (case_a.m, 0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_index_parallel_skr_matches_reference(pools, case_a, case_b, layout):
    S = layout[1]
    for c, max_leaves, want in ((case_a, case_a.K, case_a.skr), (case_b, 2, case_b.skr2),
                                (case_b, case_b.K, case_b.skr)):
        (got, again), _ = _serve(pools, layout, "serve_index_sharded",
                                 (c.psnap(S), c.rects, c.bms, max_leaves), repeat=2)
        assert got["ids"].shape[0] == c.m
        _skr_same_sets(got, want, c.m)
        _same_results(again, got)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_index_parallel_knn_matches_reference(pools, case_a, layout):
    S = layout[1]
    for k, want in ((5, case_a.knn5), (1, case_a.knn1)):
        (got,), _ = _serve(pools, layout, "serve_knn_index_sharded",
                           (case_a.psnap(S), case_a.points, case_a.bms, k))
        port = retrieve_knn(case_a.snap, case_a.points, case_a.bms, k, plan_cache=PlanCache())
        _same_keys(got, want, KNN_KEYS, ulp=("dist2",))
        _same_keys(got, port, KNN_KEYS)
    (got,), _ = _serve(pools, layout, "serve_knn_index_sharded",
                       (case_a.psnap(S), case_a.points, case_a.bms, 0))
    assert got["ids"].shape == (case_a.m, 0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_both_regimes_with_a_live_delta_match_reference(pools, case_d, layout):
    c, S = case_d, layout[1]
    buf = c.log.buffer
    port_knn = retrieve_knn(c.snap, c.points, c.bms, 5, plan_cache=PlanCache(), delta=buf)
    (got,), _ = _serve(pools, layout, "serve_sharded", (c.snap, c.rects, c.bms, c.K),
                       dict(delta=buf))
    _same_keys(got, c.dskr, SKR_KEYS)
    (got,), _ = _serve(pools, layout, "serve_knn_sharded", (c.snap, c.points, c.bms, 5),
                       dict(delta=buf))
    _knn_same(got, c.dknn5, port_knn)
    (got,), _ = _serve(pools, layout, "serve_index_sharded", (c.psnap(S), c.rects, c.bms, c.K),
                       dict(delta=buf))
    _skr_same_sets(got, c.dskr, c.m)
    (got,), _ = _serve(pools, layout, "serve_knn_index_sharded",
                       (c.psnap(S), c.points, c.bms, 5), dict(delta=buf))
    _same_keys(got, c.dknn5, KNN_KEYS, ulp=("dist2",))
    _same_keys(got, port_knn, KNN_KEYS)


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)])
def test_both_regimes_at_nonfinite_queries_match_single_device(pools, case_b, layout):
    """The six ``with_nonfinite`` rows of tests/test_torch_nonfinite.py in
    a MIX batch of 20 on its three-level layout."""
    c, S = case_b, layout[1]
    wl = make_workload(c.ds, m=20, dist="MIX", seed=6)
    rects, points, bms = with_nonfinite(wl.rects), with_nonfinite(_points(wl.rects)), wl.kw_bitmap
    assert (~np.isfinite(rects).all(1)).sum() == (~np.isfinite(points).all(1)).sum() == 6
    skr = retrieve(c.snap, rects, bms, c.K, plan_cache=PlanCache())
    knn = retrieve_knn(c.snap, points, bms, 5, plan_cache=PlanCache())
    (got,), _ = _serve(pools, layout, "serve_sharded", (c.snap, rects, bms, c.K))
    _same_keys(got, skr, SKR_KEYS)
    (got,), _ = _serve(pools, layout, "serve_knn_sharded", (c.snap, points, bms, 5))
    _same_keys(got, knn, KNN_KEYS + ("frontier_widths",))
    (got,), _ = _serve(pools, layout, "serve_index_sharded", (c.psnap(S), rects, bms, c.K))
    _skr_same_sets(got, skr, 20)
    (got,), _ = _serve(pools, layout, "serve_knn_index_sharded", (c.psnap(S), points, bms, 5))
    _same_keys(got, knn, KNN_KEYS)


@pytest.mark.parametrize("tag", ["plain", "delta"])
def test_exact_layout_equals_the_reference_on_four_devices(pools, case_d, forced_reference, tag):
    """The (1, 4) layout against the reference's forced 4-device run, array
    for array: SKR id order, ``nodes_scanned`` and ``frontier_widths``
    included; kNN ``dist2`` to 1 ulp."""
    ref = np.load(_finished(forced_reference))
    c = case_d
    delta = dict(delta=c.log.buffer) if tag == "delta" else {}
    (skr,), _ = _serve(pools, (1, 4), "serve_index_sharded", (c.psnap(4), c.rects, c.bms, c.K),
                       delta)
    (knn,), _ = _serve(pools, (1, 4), "serve_knn_index_sharded",
                       (c.psnap(4), c.points, c.bms, 5), delta)
    for name, got in (("skr", skr), ("knn", knn)):
        want = {k[len(name) + len(tag) + 2:]: ref[k] for k in ref.files
                if k.startswith(f"{name}_{tag}_")}
        assert set(want) == set(got), name
        _same_keys(got, want, sorted(want), ulp=("dist2",))


def test_sharded_live_index_equals_single_device(pools):
    """``LiveIndex(index_shards=2)`` (a (1, 2) mesh) and the single-device
    ``LiveIndex`` over the same build take the same serves, kNN batches,
    inserts, deletes and a forced swap: equal step for step (SKR id sets,
    every counter; kNN every key), the insert visible on the next batch.
    The build is the port's (tests/test_torch_build.py's config on
    tests/test_torch_live.py's data): a reference build small enough for
    this file has a single root, which no index shard count above one can
    cut."""
    from repro_torch.data.synth import make_dataset

    ds = make_dataset("fs", n=1500, seed=0)
    train = make_workload(ds, m=32, dist="LAP", seed=1)
    cfg = port_config(0)
    art = build_wisk(ds, train, cfg, device="cpu")
    assert art.index.levels[0].n >= 2
    rng = np.random.default_rng(5)
    wls = [make_workload(ds, m=24, dist=d, seed=s) for d, s in (("LAP", 21), ("LAP", 22),
                                                                ("UNI", 31), ("UNI", 32))]
    src = rng.choice(ds.n, 30)
    locs = np.clip(ds.locs[src] + rng.normal(0, 0.02, (30, 2)).astype(np.float32), 0, 1)
    r0, b0 = wls[1].rects[0], wls[1].kw_bitmap[0]
    centre = np.array([[(r0[0] + r0[2]) / 2, (r0[1] + r0[3]) / 2]], np.float32)
    term = min(32 * w + b for w in range(b0.size) for b in range(32) if (int(b0[w]) >> b) & 1)
    centre_kw = np.full((1, ds.kw_ids.shape[1]), -1, np.int32)
    centre_kw[0, 0] = term
    steps = [("serve", wls[0].rects, wls[0].kw_bitmap, 64),
             ("insert", locs, ds.kw_ids[src]),
             ("insert", centre, centre_kw),
             ("serve", wls[1].rects, wls[1].kw_bitmap, 64),
             ("delete", [int(i) for i in rng.choice(ds.n, 15, replace=False)] + [ds.n]),
             ("knn", _points(wls[1].rects), wls[1].kw_bitmap, 5),
             ("serve", wls[2].rects, wls[2].kw_bitmap, 64),
             ("rebuild", True),
             ("serve", wls[3].rects, wls[3].kw_bitmap, 64),
             ("insert", locs[:5], ds.kw_ids[src[:5]]),
             ("knn", _points(wls[3].rects), wls[3].kw_bitmap, 5),
             ("serve", wls[3].rects, wls[3].kw_bitmap, 64)]
    live_kw = dict(dataset=ds, workload=train, build_config=cfg,
                   drift_config=DriftConfig(threshold=1.3, min_queries=48), artifacts=art)
    got = _run(pools, (1, 2), "live", steps, live_kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' setting: the rebuild's sums in the same order
    try:
        want = run_live_steps(LiveIndex(device="cpu", **live_kw), steps)
    finally:
        torch.set_num_threads(threads)
    assert [s[0] for s in got] == [s[0] for s in want]
    for (op, g, seq), (_, w, wseq) in zip(got, want):
        assert seq == wseq, op
        if op == "serve":
            _skr_same_sets(g, w, 24)
        elif op == "knn":
            _same_keys(g, w, KNN_KEYS)
        else:
            _same_results(g, w)
    assert got[7][1] is True and got[7][2] == 1  # the forced swap
    new_id = int(got[2][1][0])  # served by the very next batch
    assert new_id >= ds.n and new_id in got[3][1]["ids"][0]


def _ref_flat_step(q_rects, q_bm, leaves, n_shards, **kw):
    """The reference's ``wisk_serve_step`` with its leaf rows split into
    ``n_shards`` blocks: one ``vmap`` lane a shard under the axis name
    ``model``, so its ``psum`` sums over the shards as its mesh would."""
    import functools

    import jax
    from repro.launch.flat_legacy import wisk_serve_step as jstep

    u32 = lambda t: t.numpy().view(np.uint32)  # noqa: E731
    host = [t.numpy() for t in leaves]
    host[1], host[4] = u32(leaves[1]), u32(leaves[4])
    stacked = [a.reshape((n_shards, -1) + a.shape[1:]) for a in host]
    step = jax.vmap(functools.partial(jstep, **kw), in_axes=(None, None) + (0,) * 6,
                    axis_name="model")
    out = [np.asarray(o) for o in step(q_rects.numpy(), u32(q_bm), *stacked)]
    for o in out:  # psum'd: every lane holds the same sums
        assert (o == o[:1]).all()
    return [o[0] for o in out]


@pytest.mark.parametrize("two_stage", [False, True])
def test_flat_step_on_two_ranks_equals_its_plain_sum(pools, two_stage):
    """Leaves split over the index axis of a (1, 2) mesh and queries over
    the data axis of a (2, 1) mesh: counts, scanned and overflow equal the
    reference's step over the same leaf shards (two, then one) and the
    port's single-process step summed over the shards. Every leaf holds
    300 or 400 objects, so many relevant leaves tie on score and the top
    leaves' order (``lax.top_k``: the lower column first) decides what is
    verified; with ``stage2_cap`` 64 the capacity bound overflows."""
    rng = np.random.default_rng(11)
    M, K, W = 16, 32, 2
    lo = rng.uniform(0, 0.7, (K, 2)).astype(np.float32)
    leaf_mbrs = np.concatenate([lo, lo + 0.3], 1)
    q_lo = rng.uniform(0, 0.6, (M, 2)).astype(np.float32)
    q_rects = torch.from_numpy(np.concatenate([q_lo, q_lo + 0.4], 1))
    q_bm = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (M, W), dtype=np.int64).astype(np.int32))
    valid = np.zeros((K, OBJ_PER_LEAF), np.int8)
    for k, n in enumerate(rng.choice([300, 400], K)):
        valid[k, rng.permutation(OBJ_PER_LEAF)[:n]] = 1
    leaves = [
        torch.from_numpy(leaf_mbrs),
        torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (K, W), dtype=np.int64).astype(np.int32)),
        torch.from_numpy(rng.uniform(0, 1, (K, OBJ_PER_LEAF)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0, 1, (K, OBJ_PER_LEAF)).astype(np.float32)),
        torch.from_numpy((rng.integers(0, 16, (K, OBJ_PER_LEAF, W)) << 27).astype(np.int32)),
        torch.from_numpy(valid),
    ]
    kw = dict(two_stage=two_stage, stage2_cap=64)
    halves = [wisk_serve_step(q_rects, q_bm, *[t[s * K // 2:(s + 1) * K // 2] for t in leaves],
                              **kw) for s in range(2)]
    plain = [(a + b).numpy() for a, b in zip(*halves)]
    want = _ref_flat_step(q_rects, q_bm, leaves, 2, **kw)
    got = _run(pools, (1, 2), "flat_step", q_rects, q_bm, leaves, kw)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p, w)
    assert want[0].sum() > 0 and (not two_stage or want[2].sum() > 0)
    # the data reaches the tie order: in some shard a query's last verified
    # leaf ties on score with the first one left out
    top = []
    for s in range(2):
        cut = slice(s * K // 2, (s + 1) * K // 2)
        rel = ops.filter_pairs(q_rects, q_bm, leaves[0][cut], leaves[1][cut]).numpy()
        score = np.sort(rel * (1 + valid[cut].sum(1)), axis=1)[:, ::-1]
        top.append(score[:, TOP_LEAVES_LOCAL - 1] == score[:, TOP_LEAVES_LOCAL])
        top[-1] &= score[:, TOP_LEAVES_LOCAL] > 0
    assert np.any(top)
    want = _ref_flat_step(q_rects, q_bm, leaves, 1, **kw)  # one shard: no sum
    whole = wisk_serve_step(q_rects, q_bm, *leaves, **kw)
    got = _run(pools, (2, 1), "flat_step", q_rects, q_bm, leaves, kw)
    for g, w, p in zip(got, want, whole):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p.numpy(), w)


def test_replica_memo_keeps_no_dropped_snapshot_alive(case_a):
    """A snapshot or delta buffer already on the mesh rank's device is its
    own replica: once the caller drops it, nothing of the query-parallel
    memo holds it (each rank's own ``cuda:r`` build in an NCCL layout)."""
    mesh = make_serving_mesh(device="cpu")
    snap = IndexSnapshot.build(case_a.index, case_a.ds, device="cpu")
    log = _updated(case_a.ds, case_a.index, snap, DeltaLog)
    buf = log.buffer
    assert _replicated(snap, mesh) is snap and _replicated(buf, mesh) is buf
    refs = [weakref.ref(snap), weakref.ref(buf)]
    del snap, buf, log
    gc.collect()
    assert [r() for r in refs] == [None, None]


def test_global_rank_counts_smaller_keys():
    """``_global_rank`` of every shard's finite keys equals the reference's
    count of strictly smaller gathered keys (its (M, F, S*F) compare, run
    here at a small shape), with NaN, +inf and equal distances mixed in."""
    rng = np.random.default_rng(4)
    M, F, S = 5, 7, 3
    d = rng.choice(np.array([0.0, 0.25, 0.5, 1.0, np.inf, np.nan], np.float32), (M, S * F))
    gid = np.stack([rng.permutation(S * F) for _ in range(M)]).astype(np.int32)
    gid[~np.isfinite(d)] = np.iinfo(np.int32).max
    less = (d[:, None, :] < d[:, :, None]) | ((d[:, None, :] == d[:, :, None])
                                              & (gid[:, None, :] < gid[:, :, None]))
    want = less.sum(axis=2)
    for s in range(S):
        got = _global_rank(torch.from_numpy(d), torch.from_numpy(gid), s, F).numpy()
        fin = np.isfinite(d[:, s * F:(s + 1) * F])
        np.testing.assert_array_equal(got[fin], want[:, s * F:(s + 1) * F][fin])
    assert (~np.isfinite(d)).any() and np.isnan(d).any()


def test_global_rank_memory_stays_bounded():
    """M = 256 queries, F = 4096 leaf slots, S = 2 shards: the reference's
    boolean compare would be 256 x 4096 x 8192 = 8.6 GB; the port's ranks
    grow the process's peak memory by under 256 MB (a fresh process)."""
    code = r"""
import resource, sys
import torch
from repro_torch.serve.engine import _global_rank
torch.manual_seed(0)
M, F, S = 256, 4096, 2
gd = torch.rand(M, S * F)
gg = torch.stack([torch.randperm(S * F, dtype=torch.int32) for _ in range(M)])
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
rank = _global_rank(gd, gg, 1, F)
grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
assert rank.shape == (M, F) and int(rank.min()) >= 0 and int(rank.max()) < S * F
print(grown * 1024)
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                      os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) < 256 * 2 ** 20
