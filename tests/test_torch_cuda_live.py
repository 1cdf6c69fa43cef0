"""The live front door (``LiveIndex``) on the card against the same front
door on the CPU.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips elsewhere. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_live.py

One CPU build's artifacts go to a ``LiveIndex`` on each device (the bank
moves with ``CDFBank.to``). Through the scenario up to the swap -- LAP
resamples, geofences, inserts, deletes, a kNN batch with the delta, the
shift to UNI -- both give equal outputs on every key (the CUDA kernels equal
their plain versions bit for bit), equal monitor states and equal
notifications. The warm rebuild's split learner then runs on each device,
and a bank evaluated on the card may move a split, so after the swap each
device is held to its own generation: served ids equal
``exact_query_result_ids`` over that generation's dataset, and the
notification stream equals ``SubscriptionOracle``. A ``LiveIndex`` built
through its own constructor on the card serves exactly as well.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.build import BuildConfig, build_wisk  # noqa: E402
from repro_torch.core.cost import exact_query_result_ids  # noqa: E402
from repro_torch.core.drift import DriftConfig  # noqa: E402
from repro_torch.core.packing import PackingConfig  # noqa: E402
from repro_torch.core.partition import PartitionConfig  # noqa: E402
from repro_torch.core.query import SubscriptionOracle  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.launch.wisk_serve import LiveIndex  # noqa: E402

pytestmark = pytest.mark.cuda

MAX_LEAVES = 64


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _config():
    """The JAX package tests' tiny build config."""
    return BuildConfig(
        partition=PartitionConfig(max_clusters=24, n_steps=25, n_restarts=2),
        packing=PackingConfig(epochs=3, max_label_queries=16),
        cdf_train_steps=40,
        cdf_force_class="gauss",
        use_itemsets=False,
    )


@pytest.fixture(scope="module")
def built(cuda):
    ds = make_dataset("fs", n=1500, seed=0)
    train = make_workload(ds, m=32, dist="LAP", seed=1)
    return ds, train, build_wisk(ds, train, _config(), device="cpu")


def _points(wl):
    return np.stack([(wl.rects[:, 0] + wl.rects[:, 2]) / 2,
                     (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1).astype(np.float32)


def _arrivals(ds, rng, n):
    src = rng.choice(ds.n, n)
    locs = np.clip(ds.locs[src] + rng.normal(0, 0.02, (n, 2)).astype(np.float32), 0, 1)
    return locs, ds.kw_ids[src]


def _equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


def _exact(live, rects, bms, out):
    """``out``'s ids equal the exact answer over the current generation's
    objects with its buffered updates merged in."""
    ds = live.generation.delta_log.merged_dataset()
    assert (out["overflow"] == 0).all()
    for q in range(len(rects)):
        row = out["ids"][q]
        np.testing.assert_array_equal(np.sort(row[row >= 0]),
                                      np.sort(exact_query_result_ids(ds, rects[q], bms[q])))


@pytest.fixture(scope="module")
def pair(cuda, built):
    """The same scenario on both devices up to and through the swap; the
    two front doors, the per-step outputs and the oracle's stream."""
    ds, train, art = built
    lives = [LiveIndex(ds, train, _config(), DriftConfig(threshold=1.3, min_queries=48),
                       artifacts=art, device=dev) for dev in (cuda, "cpu")]
    rng = np.random.default_rng(5)
    orc = SubscriptionOracle()
    steps = []

    def both(what, fn):
        steps.append((what, [fn(live) for live in lives],
                      [(lv.monitor.state, lv.monitor.ratio) for lv in lives]))

    def serve(dist, seed):
        wl = make_workload(ds, m=24, dist=dist, seed=seed)
        both(f"{dist} {seed}", lambda lv: lv.serve(wl.rects, wl.kw_bitmap, MAX_LEAVES))

    def insert(n):
        locs, kw = _arrivals(ds, rng, n)
        both(f"insert {n}", lambda lv: dict(ids=lv.insert(locs, kw)))
        orc.arrive(steps[-1][1][0]["ids"], locs, kw)

    for seed in (21, 22, 23, 24):
        serve("LAP", seed)
    for _ in range(8):
        c = ds.locs[rng.integers(ds.n)]
        w, h = rng.uniform(0.1, 0.3, size=2)
        rect = np.array([c[0] - w, c[1] - h, c[0] + w, c[1] + h], np.float32)
        kw = rng.choice(4, size=rng.integers(1, 4), replace=False)
        assert [lv.subscribe(rect, kw) for lv in lives] == [orc.subscribe(rect, kw)] * 2
    insert(30)
    new = steps[-1][1][0]["ids"]
    dels = np.concatenate([rng.choice(ds.n, 12, replace=False), new[[0, 7, -1]]])
    both("delete", lambda lv: dict(n=np.int64(lv.delete(dels))))
    serve("LAP", 25)
    knn = make_workload(ds, m=24, dist="LAP", seed=26)
    both("knn", lambda lv: lv.serve_knn(_points(knn), knn.kw_bitmap, 5))
    both("drain", lambda lv: dict(ids=lv.drain_notifications()))
    insert(10)
    for seed in range(31, 37):
        serve("UNI", seed)
    swapped = [lv.maybe_rebuild() for lv in lives]
    locs, kw = _arrivals(ds, rng, 20)
    post = [lv.insert(locs, kw) for lv in lives]  # the stream goes on after the swap
    orc.arrive(post[0], locs, kw)
    return lives, steps, swapped, orc, post


def test_pre_swap_scenario_on_card_equals_cpu(pair):
    lives, steps, _, _, _ = pair
    assert lives[0].generation.snapshot.device.type == "cuda"
    assert lives[1].generation.snapshot.device.type == "cpu"
    for what, (got, want), (mon_cuda, mon_cpu) in steps:
        _equal(got, want, what)
        assert mon_cuda == mon_cpu, what
    assert steps[-1][2][0][0] == "triggered"


def test_each_device_swaps_and_serves_its_generation_exactly(pair):
    lives, _, swapped, _, post = pair
    assert swapped == [True, True]
    np.testing.assert_array_equal(post[0], post[1])
    for lv in lives:
        gen = lv.generation
        assert gen.seq == 1 and gen.dataset.n == 1540 and gen.delta_log.n_updates() == 20
        assert gen.artifacts.bank.device == gen.snapshot.device
        for seed in (41, 42):
            wl = make_workload(gen.dataset, m=24, dist="UNI", seed=seed)
            _exact(lv, wl.rects, wl.kw_bitmap, lv.serve(wl.rects, wl.kw_bitmap, MAX_LEAVES))


def test_notification_stream_equals_oracle(pair):
    lives, steps, _, orc, _ = pair
    drained = [s for s in steps if s[0] == "drain"][0][1][0]["ids"]
    want = orc.drain()
    for lv in lives:
        got = np.concatenate([drained, lv.drain_notifications()])
        np.testing.assert_array_equal(got, want)
        assert lv.drain_notifications().shape == (0, 2)


def test_front_door_built_on_card_serves_exactly(cuda, built):
    ds, train, _ = built
    live = LiveIndex(ds, train, _config(), device=cuda)
    assert live.generation.artifacts.bank.device.type == "cuda"
    wl = make_workload(ds, m=32, dist="MIX", seed=7)
    _exact(live, wl.rects, wl.kw_bitmap, live.serve(wl.rects, wl.kw_bitmap, MAX_LEAVES))
    locs, kw = _arrivals(ds, np.random.default_rng(8), 16)
    live.insert(locs, kw)
    _exact(live, wl.rects, wl.kw_bitmap, live.serve(wl.rects, wl.kw_bitmap, MAX_LEAVES))
