"""The port's construction building blocks against the JAX package.

The numpy modules (``core/cost.py``, ``core/itemsets.py``,
``data/workloads.stratified_sample``, ``core/query.execute_level_sync``,
``core/drift.py``) are copies and must agree bit for bit. The CDF bank
(``core/cdf.py``) trains and evaluates in torch on the same numpy inputs:
its class tables bit for bit, ``mlp_apply`` within 1e-6 at carried weights,
40 Adam steps from the reference's init within 1e-4 at the quantile points
and 1e-4 relative on the loss, and ``eval_cdf`` / ``est_count_rect`` /
``cdf_table_fn`` within 1e-5 relative at a carried bank.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines.conventional import build_str_rtree as jbuild_str_rtree  # noqa: E402
from repro.core import cdf as jcdf  # noqa: E402
from repro.core import cost as jcost  # noqa: E402
from repro.core import drift as jdrift  # noqa: E402
from repro.core.itemsets import expand_queries as jexpand  # noqa: E402
from repro.core.itemsets import mine_frequent_itemsets as jmine  # noqa: E402
from repro.core.query import execute_level_sync as jlevel_sync  # noqa: E402
from repro.data.synth import make_dataset as jmake_dataset  # noqa: E402
from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.data.workloads import stratified_sample as jstratified  # noqa: E402
from repro_torch.baselines.conventional import build_str_rtree  # noqa: E402
from repro_torch.core import cdf as tcdf  # noqa: E402
from repro_torch.core import cost as tcost  # noqa: E402
from repro_torch.core import drift as tdrift  # noqa: E402
from repro_torch.core.itemsets import expand_queries, mine_frequent_itemsets  # noqa: E402
from repro_torch.core.query import DEFAULT_W1, DEFAULT_W2, execute_level_sync  # noqa: E402
from repro_torch.core.types import ClusterSet  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload, stratified_sample  # noqa: E402


def _pair(profile="fs", n=600, seed=21, m=16, dist="MIX", wseed=22):
    ds, jds = make_dataset(profile, n=n, seed=seed), jmake_dataset(profile, n=n, seed=seed)
    return ds, make_workload(ds, m=m, dist=dist, seed=wseed), jds, jmake_workload(jds, m=m, dist=dist, seed=wseed)


def _grid_clusters(ds, g=5):
    cell = np.minimum((ds.locs * g).astype(np.int32), g - 1)
    _, assign = np.unique(cell[:, 0] * g + cell[:, 1], return_inverse=True)
    return ClusterSet.from_assignment(ds, assign.astype(np.int32))


def _bank_fields(bank):
    return dict(cls=bank.cls, count=bank.count, gauss=bank.gauss, nn_slot=bank.nn_slot,
                nn_params=None if bank.nn_params is None else
                {k: np.asarray(v) for k, v in bank.nn_params.items()},
                vocab_size=bank.vocab_size, train_loss=bank.train_loss)


@pytest.fixture(scope="module")
def fixture():
    ds, wl, jds, jwl = _pair()
    itemsets, members = jmine(jds)
    jbank = jcdf.build_cdf_bank(jds, itemsets, members, n_steps=40)
    return ds, wl, jds, jwl, itemsets, members, jbank


# ------------------------------------------------------------------ numpy copies
def test_numpy_modules_match_reference(fixture):
    ds, wl, jds, jwl, *_ = fixture
    assert (DEFAULT_W1, DEFAULT_W2) == (jcost.DEFAULT_W1, jcost.DEFAULT_W2)
    clusters = _grid_clusters(ds)
    got, want = tcost.exact_workload_cost(ds, clusters, wl), jcost.exact_workload_cost(jds, clusters, jwl)
    assert (got.filter_checks, got.verified_objects, got.total) == (
        want.filter_checks, want.verified_objects, want.total)
    np.testing.assert_array_equal(got.per_query, want.per_query)
    np.testing.assert_array_equal(tcost.object_query_match(ds, wl), jcost.object_query_match(jds, jwl))
    _, wide, _, jwide = _pair(profile="osm", n=300, m=40, wseed=2)  # W = 256 words
    np.testing.assert_array_equal(tcost.object_query_match(make_dataset("osm", n=300, seed=21), wide),
                                  jcost.object_query_match(jmake_dataset("osm", n=300, seed=21), jwide))
    np.testing.assert_array_equal(tcost.exact_query_results(ds, wl), jcost.exact_query_results(jds, jwl))
    for q in range(4):
        np.testing.assert_array_equal(
            tcost.exact_query_result_ids(ds, wl.rects[q], wl.kw_bitmap[q]),
            jcost.exact_query_result_ids(jds, jwl.rects[q], jwl.kw_bitmap[q]))
    for ratio, seed in ((0.3, 0), (0.5, 4), (0.05, 1)):
        np.testing.assert_array_equal(stratified_sample(wl, ratio, seed=seed),
                                      jstratified(jwl, ratio, seed=seed))


@pytest.mark.parametrize("max_size,use_itemsets", [(3, True), (2, True), (3, False)])
def test_itemsets_and_expansion_match_reference(fixture, max_size, use_itemsets):
    ds, wl, jds, jwl, *_ = fixture
    got, got_mem = mine_frequent_itemsets(ds, max_size=max_size, max_itemsets=300)
    want, want_mem = jmine(jds, max_size=max_size, max_itemsets=300)
    assert got == want and len(got) > 0
    for a, b in zip(got_mem, want_mem):
        np.testing.assert_array_equal(a, b)
    e, s = expand_queries(wl, got, ds.vocab_size, use_itemsets=use_itemsets)
    je, js = jexpand(jwl, want, jds.vocab_size, use_itemsets=use_itemsets)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(s, js)
    if use_itemsets:
        assert (e >= ds.vocab_size).any()


def test_execute_level_sync_and_drift_match_reference(fixture):
    ds, wl, jds, jwl, *_ = fixture
    index, jindex = build_str_rtree(ds, leaf_size=16, fanout=4), jbuild_str_rtree(jds, leaf_size=16, fanout=4)
    got, want = execute_level_sync(index, ds, wl), jlevel_sync(jindex, jds, jwl)
    for f in ("nodes_accessed", "verified", "cost"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for a, b in zip(got.results, want.results):
        np.testing.assert_array_equal(a, b)
    assert tdrift.index_cost_baseline(index, ds, wl) == jdrift.index_cost_baseline(jindex, jds, jwl)

    _, wl2, _, jwl2 = _pair(m=24, dist="GAU", wseed=5)
    prof = [tdrift.leaf_cost_profile(ds, index.clusters, w) for w in (wl, wl2)]
    jprof = [jdrift.leaf_cost_profile(jds, jindex.clusters, w) for w in (jwl, jwl2)]
    for a, b in zip(prof, jprof):
        np.testing.assert_array_equal(a, b)
    for ratio, floor in ((1.5, 1.0), (1.1, 0.0)):
        mask = tdrift.regressed_leaves(*prof, ratio=ratio, min_cost=floor)
        np.testing.assert_array_equal(mask, jdrift.regressed_leaves(*jprof, ratio=ratio, min_cost=floor))
    ow, jow = (tdrift.observed_workload(wl2.rects, wl2.kw_bitmap, ds.vocab_size),
               jdrift.observed_workload(jwl2.rects, jwl2.kw_bitmap, jds.vocab_size))
    for f in ("rects", "kw_ids", "kw_bitmap"):
        np.testing.assert_array_equal(getattr(ow, f), getattr(jow, f))


@pytest.mark.parametrize("baseline", [None, 40.0])
def test_drift_monitor_state_matches_reference(baseline):
    rng = np.random.default_rng(3)
    cfg, jcfg = tdrift.DriftConfig(min_queries=12), jdrift.DriftConfig(min_queries=12)
    mon, jmon = tdrift.DriftMonitor(baseline, cfg), jdrift.DriftMonitor(baseline, jcfg)
    seen = set()
    for i in range(12):
        scale = 30.0 if i < 6 else 120.0  # a shift half way
        nodes, ver = rng.integers(0, 50, 5), rng.poisson(scale, 5)
        mon.observe_counters(nodes, ver)
        jmon.observe_counters(nodes, ver)
        if i == 9:
            mon.rearm(baseline)
            jmon.rearm(baseline)
        mon.observe(np.array([]))
        jmon.observe(np.array([]))
        assert (mon.state, mon.baseline, mon.ewma, mon.n_observed, mon.ratio) == (
            jmon.state, jmon.baseline, jmon.ewma, jmon.n_observed, jmon.ratio)
        seen.add(mon.state)
    assert mon.history == jmon.history
    assert "triggered" in seen and "armed" in seen


# ------------------------------------------------------------------ the CDF bank
def test_cdf_bank_tables_match_reference(fixture):
    ds, _, jds, _, itemsets, members, jbank = fixture
    bank = tcdf.build_cdf_bank(ds, itemsets, members, n_steps=40, device="cpu")
    assert (jbank.cls == tcdf.CLASS_HIGH).sum() > 0 and (jbank.cls == tcdf.CLASS_MED).sum() > 0
    for f in ("cls", "count", "gauss", "nn_slot"):
        np.testing.assert_array_equal(getattr(bank, f), getattr(jbank, f), err_msg=f)
    assert bank.vocab_size == jbank.vocab_size and bank.n_entries == jbank.n_entries
    assert {k: v.shape for k, v in bank.nn_params.items()} == {
        k: v.shape for k, v in jbank.nn_params.items()}
    for force in ("gauss", "nn"):
        a = tcdf.build_cdf_bank(ds, n_steps=2, force_class=force, device="cpu")
        b = jcdf.build_cdf_bank(jds, n_steps=2, force_class=force)
        np.testing.assert_array_equal(a.cls, b.cls)


@pytest.mark.parametrize("hidden,layers", [(16, 2), (8, 3)])
def test_mlp_apply_matches_reference(hidden, layers):
    widths = (1,) + (hidden,) * layers + (1,)
    keys = jax.random.split(jax.random.PRNGKey(hidden), 5)
    jp = jax.vmap(lambda k: jcdf.mlp_init(k, widths))(keys)
    x = np.random.default_rng(1).normal(0.5, 0.6, (5, 33)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p, xi: jcdf.mlp_apply(p, xi[:, None]))(jp, jnp.asarray(x)))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    got = tcdf.mlp_apply(tp, torch.as_tensor(x)[..., None]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    one = tcdf.mlp_apply({k: v[2] for k, v in tp.items()}, torch.as_tensor(x[2])[:, None]).numpy()
    np.testing.assert_allclose(one, want[2], atol=1e-6, rtol=0)
    gen = torch.Generator().manual_seed(0)
    init = tcdf.mlp_init(gen, widths, n_models=3)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: (3,) + tuple(v.shape[1:]) for k, v in jp.items()}


def test_train_mlp_bank_from_reference_init_matches(fixture):
    """40 Adam steps from the reference's own initial weights, on the same
    quantile data: outputs at the quantile points within 1e-4, final loss
    within 1e-4 relative."""
    ds, _, jds, _, *_ = fixture
    high = np.nonzero(_grid_counts(ds) >= 0.001 * ds.n)[0][:12]
    xs, ys = [], []
    for e in high:
        pts = ds.locs[np.any(ds.kw_ids == e, axis=1)]
        for d in range(2):
            x, y = tcdf._empirical_quantiles(pts[:, d], 32)
            jx, jy = jcdf._empirical_quantiles(pts[:, d], 32)
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
            xs.append(x)
            ys.append(y)
    xs, ys = np.stack(xs), np.stack(ys)
    keys = jax.random.split(jax.random.PRNGKey(0), xs.shape[0])
    jinit = jax.vmap(lambda k: jcdf.mlp_init(k, (1, 16, 16, 1)))(keys)
    jparams, jloss = jcdf._train_mlp_bank(jinit, jnp.asarray(xs), jnp.asarray(ys), n_steps=40)
    tinit = {k: torch.as_tensor(np.array(v)) for k, v in jinit.items()}
    tparams, loss = tcdf._train_mlp_bank(tinit, torch.as_tensor(xs), torch.as_tensor(ys), n_steps=40)
    want = np.asarray(jax.vmap(lambda p, xi: jcdf.mlp_apply(p, xi[:, None]))(jparams, jnp.asarray(xs)))
    got = tcdf.mlp_apply(tparams, torch.as_tensor(xs)[..., None]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    assert tinit["w0"].abs().sum() > 0 and not torch.equal(tparams["w1"], tinit["w1"])


def _grid_counts(ds):
    return np.bincount(ds.kw_ids[ds.kw_ids >= 0], minlength=ds.vocab_size)


def test_cdf_evaluation_matches_reference_at_carried_bank(fixture):
    _, _, _, _, _, _, jbank = fixture
    bank = tcdf.bank_from_reference(_bank_fields(jbank), device="cpu")
    assert bank.device == torch.device("cpu") and bank.train_loss == jbank.train_loss
    tables, jtables = bank.tables(), jbank.jax_tables()
    rng = np.random.default_rng(5)
    n = 700
    eids = rng.integers(-1, jbank.n_entries, n).astype(np.int32)
    high = np.nonzero(jbank.cls == jcdf.CLASS_HIGH)[0][:60]
    eids[: high.size] = high
    x = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    te = torch.as_tensor(eids, dtype=torch.int64)
    for d in (0, 1):
        want = np.asarray(jcdf.eval_cdf(jtables, jbank.nn_params, jnp.asarray(eids), jnp.asarray(x), d))
        got = tcdf.eval_cdf(tables, bank.nn_params, te, torch.as_tensor(x), d).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    lo = rng.uniform(0, 0.8, (n, 2)).astype(np.float32)
    rect = np.concatenate([lo, lo + rng.uniform(0, 0.4, (n, 2)).astype(np.float32)], 1)
    want = np.asarray(jcdf.est_count_rect(jtables, jbank.nn_params, jnp.asarray(eids), jnp.asarray(rect)))
    got = tcdf.est_count_rect(tables, bank.nn_params, te, torch.as_tensor(rect)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # one rectangle for every entry, as the split learner asks
    want1 = np.asarray(jcdf.est_count_rect(jtables, jbank.nn_params, jnp.asarray(eids), jnp.asarray(rect[0])))
    got1 = tcdf.est_count_rect(tables, bank.nn_params, te, torch.as_tensor(rect[0])).numpy()
    np.testing.assert_allclose(got1, want1, rtol=1e-5, atol=1e-4)
    # cdf_table_fn: the bank once per distinct (entry, coordinate)
    u = torch.unique(torch.as_tensor(np.maximum(eids, 0), dtype=torch.int64))
    xs = torch.as_tensor(rng.uniform(0, 1, (3, 2, 4)).astype(np.float32))
    table = tcdf.cdf_table_fn(tables, bank.nn_params, u)(xs[..., None].expand(3, 2, 4, u.numel()))
    for d in (0, 1):
        flat = xs[:, d].reshape(-1)
        want = np.asarray(jcdf.eval_cdf(jtables, jbank.nn_params, jnp.asarray(np.repeat(u.numpy(), 12)),
                                        jnp.asarray(np.tile(flat.numpy(), u.numel())), d))
        np.testing.assert_allclose(table[:, d].permute(2, 0, 1).reshape(-1).numpy(), want,
                                   rtol=1e-5, atol=1e-7)
