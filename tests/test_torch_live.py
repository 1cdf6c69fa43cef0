"""The port's live front door (``ServingGeneration``, ``LiveIndex``) against
the JAX package's.

One tiny reference index (``fs``, n = 1500, seed 0; LAP training traffic,
m = 32, seed 1; the reference tests' tiny build config) is carried across
with ``core.build.artifacts_from_reference``. The reference's ``LiveIndex``
over that build and the port's over the carried artifacts (on the CPU)
then take the same scenario -- LAP resamples, 8 geofences, 30 inserts, 15
deletes, a kNN batch, the shift to UNI, ``maybe_rebuild()`` with no force,
post-swap traffic and inserts -- and at every step give equal outputs
(ids, counts and the Eq. 1 counters; kNN ``dist2`` to 1 ulp, since the
reference's jitted distances are FMA-contracted on the CPU, ROADMAP §C),
ids, delete counts, monitor states, observed workloads and notifications.
The warm rebuild the swap runs (``assign=merged_assignment()`` over a
grown, tombstoned dataset) gives the reference's levels exactly.

The reference's own front-door contracts run on the port as well: the
in-flight generation stays consistent across a swap, notifications stay
exactly once against ``SubscriptionOracle``, result-cache hits do not feed
the monitor and every state change invalidates the cache, and the front
door raises without CUDA unless it is given ``device="cpu"``. Both of the
port's walkthroughs (``examples/torch_*.py``) run once on the CPU.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build as jbuild  # noqa: E402
from repro.core.drift import DriftConfig as JDriftConfig  # noqa: E402
from repro.data.synth import make_dataset as jmake_dataset  # noqa: E402
from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.launch import wisk_serve as jserve  # noqa: E402
from repro_torch.core.cost import exact_query_result_ids  # noqa: E402
from repro_torch.core.drift import DriftConfig  # noqa: E402
from repro_torch.core.query import SubscriptionOracle  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.launch.wisk_serve import HotQueryCache, LiveIndex, serve_batch  # noqa: E402

from test_delta_maintenance import _tiny_build_config  # noqa: E402
from test_torch_build import _carried, port_config, ref_config  # noqa: E402
from test_torch_knn import _SKR_KEYS, _points, _same, _same_knn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MAX_LEAVES = 64
N_INS, N_DEL, N_POST = 30, 15, 20


@pytest.fixture(scope="module")
def built():
    ds, jds = make_dataset("fs", n=1500, seed=0), jmake_dataset("fs", n=1500, seed=0)
    train = make_workload(ds, m=32, dist="LAP", seed=1)
    ref = jbuild.build_wisk(jds, jmake_workload(jds, m=32, dist="LAP", seed=1),
                            _tiny_build_config())
    return ds, jds, train, ref


def _port_live(built, **kw):
    ds, _, train, ref = built
    return LiveIndex(ds, train, port_config(0), DriftConfig(threshold=1.3, min_queries=48),
                     artifacts=_carried(ref, ds, train), device="cpu", **kw)


def _monitor(m):
    return dict(state=m.state, baseline=m.baseline, ratio=m.ratio, ewma=m.ewma,
                n_observed=m.n_observed, history=list(m.history))


def _workload(live, dist, seed, m=24):
    wl = make_workload(live.generation.dataset, m=m, dist=dist, seed=seed)
    return wl.rects, wl.kw_bitmap


def _arrivals(ds, rng, n):
    src = rng.choice(ds.n, n)
    locs = np.clip(ds.locs[src] + rng.normal(0, 0.02, (n, 2)).astype(np.float32), 0, 1)
    return locs, ds.kw_ids[src]


def _geofences(ds, rng, n):
    """Rectangles around objects, keyword filters from the vocabulary's head
    (as examples/geofence_alerts.py draws them, a little wider, so that a
    few dozen arrivals notify)."""
    out = []
    for _ in range(n):
        c = ds.locs[rng.integers(ds.n)]
        w, h = rng.uniform(0.1, 0.3, size=2)
        out.append((np.array([c[0] - w, c[1] - h, c[0] + w, c[1] + h], np.float32),
                    rng.choice(4, size=rng.integers(1, 4), replace=False)))
    return out


STEPS = (["lap 21", "lap 22", "lap 23", "lap 24", "subscribe", "insert", "delete",
          "lap 25 with the delta", "knn with the delta", "drain before the shift",
          "insert undrained"]
         + [f"uni {s}" for s in range(31, 37)]
         + ["observed workload", "maybe_rebuild", "uni 41", "uni 42", "knn after the swap",
            "insert after the swap", "drain after the swap", "drain again"])


@pytest.fixture(scope="module")
def scenario(built):
    """Both front doors through the same scenario; per step the port's and
    the reference's results, and the two ``LiveIndex`` objects at the end."""
    ds, jds, train, ref = built
    port = _port_live(built)
    jlive = jserve.LiveIndex(jds, None, ref_config(0), JDriftConfig(threshold=1.3, min_queries=48),
                             artifacts=ref)
    rng = np.random.default_rng(5)
    got = {}

    def both(step, fn):
        got[step] = tuple(dict(fn(live), monitor=_monitor(live.monitor)) for live in (port, jlive))

    def serve(dist, seed):
        rects, bms = _workload(port, dist, seed)
        return lambda live: dict(out=live.serve(rects, bms, max_leaves=MAX_LEAVES))

    def knn(seed):
        wl = make_workload(port.generation.dataset, m=24, dist="LAP", seed=seed)
        return lambda live: dict(out=live.serve_knn(_points(wl), wl.kw_bitmap, 5))

    def insert(n):
        locs, kw = _arrivals(ds, rng, n)
        return lambda live: dict(ids=live.insert(locs, kw))

    for seed in (21, 22, 23, 24):
        both(f"lap {seed}", serve("LAP", seed))
    fences = _geofences(ds, rng, 8)
    both("subscribe", lambda live: dict(ids=np.array([live.subscribe(r, k) for r, k in fences])))
    both("insert", insert(N_INS))
    new = got["insert"][0]["ids"]
    dels = np.concatenate([rng.choice(ds.n, N_DEL - 3, replace=False), new[[0, 7, -1]]])
    both("delete", lambda live: dict(n=live.delete(dels)))
    both("lap 25 with the delta", serve("LAP", 25))
    both("knn with the delta", knn(26))
    both("drain before the shift", lambda live: dict(ids=live.drain_notifications()))
    both("insert undrained", insert(10))
    for seed in range(31, 37):
        both(f"uni {seed}", serve("UNI", seed))
    both("observed workload", lambda live: dict(wl=live.observed_workload()))
    old = port.generation, jlive.generation
    both("maybe_rebuild", lambda live: dict(
        swapped=live.maybe_rebuild(), seq=live.generation.seq, swaps=live.swaps,
        empty_delta=live.generation.delta() is None, n=live.generation.dataset.n))
    for seed in (41, 42):
        both(f"uni {seed}", serve("UNI", seed))
    both("knn after the swap", knn(43))
    both("insert after the swap", insert(N_POST))
    both("drain after the swap", lambda live: dict(ids=live.drain_notifications()))
    both("drain again", lambda live: dict(ids=live.drain_notifications()))
    assert list(got) == STEPS
    return got, port, jlive, old


@pytest.mark.parametrize("step", STEPS)
def test_scenario_step_matches_reference(scenario, step):
    got, want = (dict(d) for d in scenario[0][step])
    assert set(got) == set(want)
    assert got.pop("monitor") == want.pop("monitor")
    for key, g in got.items():
        w = want[key]
        if key == "out" and "dist2" in w:
            _same_knn(g, w)
        elif key == "out":
            _same(g, w, _SKR_KEYS)
        elif key == "wl":
            for f in ("rects", "kw_ids", "kw_bitmap"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
            assert g.vocab_size == w.vocab_size
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype or key == "n", key
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_scenario_trips_the_monitor_and_swaps_without_force(scenario):
    got = scenario[0]
    for step in ("lap 22", "lap 23", "lap 24", "lap 25 with the delta"):
        assert got[step][0]["monitor"]["state"] == "armed", step
    assert got["uni 36"][0]["monitor"]["state"] == "triggered"
    rebuilt = got["maybe_rebuild"][0]
    assert rebuilt["swapped"] and rebuilt["seq"] == 1 and rebuilt["swaps"] == 1
    assert rebuilt["empty_delta"] and rebuilt["n"] == 1500 + N_INS + 10
    assert rebuilt["monitor"]["state"] == "warmup"
    assert got["uni 42"][0]["monitor"]["state"] == "armed"  # re-learned on the new index
    assert len(got["drain before the shift"][0]["ids"]) > 0
    assert len(got["drain after the swap"][0]["ids"]) > 0
    assert got["drain again"][0]["ids"].shape == (0, 2)


def test_rebuilt_generation_matches_reference(scenario, built):
    _, port, jlive, _ = scenario
    ds = built[0]
    gen, jgen = port.generation, jlive.generation
    assert gen.seq == jgen.seq == 1
    assert gen.delta_log.n_updates() == N_POST  # the inserts after the swap
    assert gen.dataset.n == jgen.dataset.n == ds.n + N_INS + 10
    for f in ("locs", "kw_ids", "kw_bitmap"):
        np.testing.assert_array_equal(getattr(gen.dataset, f), getattr(jgen.dataset, f), err_msg=f)
    art, jart = gen.artifacts, jgen.artifacts
    assert art.counters == jart.counters
    assert art.counters["refined_leaves"] > 0
    np.testing.assert_array_equal(art.partition.clusters.assign, jart.partition.clusters.assign)
    assert len(art.index.levels) == len(jart.index.levels)
    for a, b in zip(art.index.levels, jart.index.levels):
        for f in ("mbrs", "bitmaps", "child_ptr", "child"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert gen.snapshot.device == torch.device("cpu") and art.bank.device == torch.device("cpu")


def test_swap_leaves_in_flight_generation_consistent(built):
    """tests/test_delta_maintenance.py's in-flight contract on the port: a
    reader that grabbed the old generation keeps serving identical results;
    the new generation starts with an empty delta log and serves the merged
    object set exactly."""
    ds = built[0]
    live = _port_live(built)
    rng = np.random.default_rng(5)
    locs, kw = _arrivals(ds, rng, 20)
    live.insert(locs, kw)
    live.delete(rng.choice(ds.n, 10, replace=False))
    rects, bms = _workload(live, "UNI", 41)
    old_gen = live.generation

    def served(gen):
        return serve_batch(gen.snapshot, rects, bms, MAX_LEAVES, plan_cache=gen.plan_cache,
                           delta=gen.delta())

    before = served(old_gen)
    live.serve(rects, bms, MAX_LEAVES)  # populate the recent window
    assert live.maybe_rebuild(force=True) and live.generation.seq == old_gen.seq + 1
    after = served(old_gen)
    _same(after, before, ("ids", "counts"))
    new_gen = live.generation
    assert new_gen.delta_log.n_updates() == 0 and new_gen.delta() is None
    assert new_gen.dataset.n == ds.n + 20
    out = live.serve(rects, bms, MAX_LEAVES)
    assert (out["overflow"] == 0).all()
    for q in range(len(rects)):
        row = out["ids"][q]
        np.testing.assert_array_equal(
            np.sort(row[row >= 0]), np.sort(exact_query_result_ids(new_gen.dataset, rects[q], bms[q])))
    assert live.monitor.state == "warmup"


def test_notifications_exactly_once_across_swap(built):
    """tests/test_streaming_match.py's swap contract on the port: queued
    notifications survive the swap, baked-in objects are never re-matched,
    the id sequence continues, and the whole stream equals the oracle's."""
    ds = built[0]
    live = _port_live(built)
    rng = np.random.default_rng(21)
    orc = SubscriptionOracle()
    for r, kw in _geofences(ds, rng, 8):
        assert live.subscribe(r, kw) == orc.subscribe(r, kw)

    def arrive(n):
        locs, kw = _arrivals(ds, rng, n)
        ids = live.insert(locs, kw)
        orc.arrive(ids, locs, kw)
        return ids

    pre = arrive(30)  # queued, not drained before the swap
    live.delete(pre[:5])  # deletes never retract queued notifications
    assert live.subscriptions.matched_total == orc.matched_total > 0
    live.serve(*_workload(live, "UNI", 41), MAX_LEAVES)
    assert live.maybe_rebuild(force=True)
    assert live.subscriptions.pump(live.generation.delta_log) == 0
    post = arrive(20)
    assert int(post.min()) > int(pre.max())
    got = live.drain_notifications()
    np.testing.assert_array_equal(got, orc.drain())
    assert (got[:, 0] <= int(pre.max())).any() and (got[:, 0] > int(pre.max())).any()
    assert live.drain_notifications().shape == (0, 2)
    assert live.unsubscribe(0) and orc.unsubscribe(0)
    arrive(10)
    np.testing.assert_array_equal(live.drain_notifications(), orc.drain())


def test_result_cache_hits_skip_the_monitor_and_state_changes_invalidate(built):
    ds = built[0]
    cache = HotQueryCache()
    live = _port_live(built, result_cache=cache)
    rects, bms = _workload(live, "LAP", 21, m=64)
    first = live.serve(rects, bms, MAX_LEAVES)
    assert not first["cached"].any() and live.monitor.n_observed == 64
    again = live.serve(rects, bms, MAX_LEAVES)
    assert again["cached"].all() and live.monitor.n_observed == 64  # hits feed nothing
    assert len(live.monitor.history) == 1
    _same({k: again[k] for k in _SKR_KEYS[:-1]}, {k: first[k] for k in _SKR_KEYS[:-1]},
          _SKR_KEYS[:-1])
    n0 = cache.invalidations
    ids = live.insert(*_arrivals(ds, np.random.default_rng(3), 4))
    assert cache.invalidations == n0 + 1 and len(cache) == 0
    live.serve(rects[:8], bms[:8], MAX_LEAVES)
    live.delete(ids[:2])
    assert cache.invalidations == n0 + 2 and len(cache) == 0
    live.serve(rects[:8], bms[:8], MAX_LEAVES)
    assert live.maybe_rebuild(force=True)
    assert cache.invalidations == n0 + 3 and len(cache) == 0
    assert not live.maybe_rebuild()  # the monitor is back in warmup


def test_knn_traffic_enters_the_window_as_points(built):
    live = _port_live(built, max_recent=40)
    wl = make_workload(live.generation.dataset, m=24, dist="LAP", seed=9)
    live.serve_knn(_points(wl), wl.kw_bitmap, 3)
    live.serve(wl.rects, wl.kw_bitmap, MAX_LEAVES)
    obs = live.observed_workload()
    assert obs.m == 40  # the window keeps the newest max_recent queries
    pts = _points(wl)[8:]
    np.testing.assert_array_equal(obs.rects[:16], np.concatenate([pts, pts], 1))
    np.testing.assert_array_equal(obs.rects[16:], wl.rects)
    np.testing.assert_array_equal(obs.kw_bitmap[:16], wl.kw_bitmap[8:])
    assert live.monitor.n_observed == 48
    assert not live.maybe_rebuild(min_observed=41)  # neither tripped nor forced


def test_front_door_runs_on_cuda_by_default(built):
    ds, _, train, ref = built
    art = _carried(ref, ds, train)
    if torch.cuda.is_available():
        live = LiveIndex(ds, train, port_config(0), artifacts=art)
        assert live.generation.snapshot.device.type == "cuda"
        assert live.generation.artifacts.bank.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveIndex(ds, train, port_config(0), artifacts=art)


@pytest.mark.parametrize("name,facts", [
    ("torch_dynamic_workload", ("monitor=armed", "monitor=triggered",
                                "warm-start rebuild swapped in: generation 0 -> 1")),
    ("torch_geofence_alerts", ("rebuild swapped mid-stream (generation 1)",
                               "second drain empty")),
])
def test_example_runs_on_cpu(name, facts, capsys):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(device="cpu")
    printed = capsys.readouterr().out
    for fact in facts:
        assert fact in printed, (fact, printed)
