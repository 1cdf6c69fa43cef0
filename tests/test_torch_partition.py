"""The port's split learner and Alg. 2 walks against the JAX package.

With the reference's CDF bank carried across (``cdf.bank_from_reference``)
split learning is deterministic, so the port must learn the same splits:
``_learn_split`` / ``_learn_split_batched`` costs and ``base`` within 1e-4
relative and values within 1e-4 of the subspace's span, and
``generate_bottom_clusters`` (both modes, a non-binding and a binding
``max_clusters``) and ``refine_partition`` the reference's assignment,
counters and sources exactly. The fixture is tests/test_build_parity.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import partition as jpart  # noqa: E402
from repro.core.cdf import build_cdf_bank as jbuild_cdf_bank  # noqa: E402
from repro.core.itemsets import expand_queries as jexpand  # noqa: E402
from repro.data.synth import make_dataset as jmake_dataset  # noqa: E402
from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core.cdf import bank_from_reference  # noqa: E402
from repro_torch.core.itemsets import expand_queries  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402


def _cfg(module, max_clusters=64):
    return module.PartitionConfig(max_clusters=max_clusters, n_steps=20, n_restarts=2,
                                  min_objects=32, query_pad=16, max_split_batch=8)


@pytest.fixture(scope="module")
def fixture():
    ds, jds = make_dataset("fs", n=500, seed=31), jmake_dataset("fs", n=500, seed=31)
    wl, jwl = make_workload(ds, m=16, dist="MIX", seed=32), jmake_workload(jds, m=16, dist="MIX", seed=32)
    jbank = jbuild_cdf_bank(jds, n_steps=50)
    bank = bank_from_reference(dict(
        cls=jbank.cls, count=jbank.count, gauss=jbank.gauss, nn_slot=jbank.nn_slot,
        nn_params={k: np.asarray(v) for k, v in jbank.nn_params.items()},
        vocab_size=jbank.vocab_size, train_loss=jbank.train_loss), device="cpu")
    qe, qs = expand_queries(wl, [], ds.vocab_size, use_itemsets=False)
    jqe, jqs = jexpand(jwl, [], jds.vocab_size, use_itemsets=False)
    np.testing.assert_array_equal(qe, jqe)
    return ds, wl, bank, jds, jwl, jbank, qe, qs


def _subspaces(ds, wl):
    """The root and its four quadrants (with their intersecting queries)."""
    root = jpart._root_subspace(ds, wl.m)
    x0, y0, x1, y1 = root.rect
    xm, ym = (x0 + x1) / 2, (y0 + y1) / 2
    out = [root]
    for rect in ([x0, y0, xm, ym], [xm, y0, x1, ym], [x0, ym, xm, y1], [xm, ym, x1, y1]):
        rect = np.asarray(rect, np.float32)
        inside = ((ds.locs[:, 0] >= rect[0]) & (ds.locs[:, 0] <= rect[2])
                  & (ds.locs[:, 1] >= rect[1]) & (ds.locs[:, 1] <= rect[3]))
        q = ((wl.rects[:, 0] <= rect[2]) & (rect[0] <= wl.rects[:, 2])
             & (wl.rects[:, 1] <= rect[3]) & (rect[1] <= wl.rects[:, 3]))
        out.append(jpart._SubSpace(rect, np.nonzero(inside)[0], np.nonzero(q)[0]))
    return out


def _assert_learned(got, want, span):
    (c, v, b), (jc, jv, jb) = got, want
    np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-4)
    np.testing.assert_allclose(b, np.asarray(jb), rtol=1e-4)
    assert np.all(np.abs(v - np.asarray(jv)) <= 1e-4 * span)


@pytest.mark.parametrize("n_steps,n_restarts", [(20, 2), (120, 4)])
def test_learn_split_matches_reference(fixture, n_steps, n_restarts):
    ds, wl, bank, jds, jwl, jbank, qe, qs = fixture
    tables, jtables = bank.tables(), jbank.jax_tables()
    kw = dict(n_steps=n_steps, n_restarts=n_restarts, beta=192.0)
    for s in _subspaces(ds, wl)[:3]:
        qr, qe_, qs_, qv = jpart._pad_queries(jwl, qe, qs, s, 16)
        want = jpart._learn_split(jtables, jbank.nn_params, *map(jnp.asarray, (s.rect, qr, qe_, qs_, qv)),
                                  **kw)
        got = tpart._learn_split(tables, bank.nn_params, s.rect, qr, qe_, qs_, qv, **kw)
        assert got[0].shape == (2,) and got[1].shape == (2,)
        _assert_learned(got, want, s.rect[2:] - s.rect[:2])


def test_learn_split_batched_matches_reference(fixture):
    ds, wl, bank, jds, jwl, jbank, qe, qs = fixture
    subs = _subspaces(ds, wl)
    padded = [jpart._pad_queries(jwl, qe, qs, s, 16) for s in subs]
    spaces = np.stack([s.rect for s in subs])
    arrays = [np.stack([p[i] for p in padded]) for i in range(4)]
    kw = dict(n_steps=30, n_restarts=3, beta=192.0)
    want = jpart._learn_split_batched(jbank.jax_tables(), jbank.nn_params,
                                      *map(jnp.asarray, [spaces] + arrays), **kw)
    got = tpart._learn_split_batched(bank.tables(), bank.nn_params, spaces, *arrays, **kw)
    assert got[0].shape == (5, 2) and got[2].shape == (5,)
    _assert_learned(got, want, spaces[:, 2:] - spaces[:, :2])


@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("max_clusters", [64, 5])
def test_partition_matches_reference(fixture, mode, max_clusters):
    """The same splits as the reference, in both modes, with a non-binding
    (64) and a binding (5) cluster budget."""
    ds, wl, bank, jds, jwl, jbank, qe, qs = fixture
    got = tpart.generate_bottom_clusters(ds, wl, bank, qe, qs, _cfg(tpart, max_clusters), mode=mode)
    want = jpart.generate_bottom_clusters(jds, jwl, jbank, qe, qs, _cfg(jpart, max_clusters), mode=mode)
    np.testing.assert_array_equal(got.clusters.assign, want.clusters.assign)
    assert (got.n_splits, got.n_sgd_calls, got.n_rounds, got.n_dispatches, got.mode) == (
        want.n_splits, want.n_sgd_calls, want.n_rounds, want.n_dispatches, want.mode)
    assert got.clusters.k == want.clusters.k > 1
    if max_clusters == 5:
        assert got.clusters.k <= 5
    assert [(h["nq"], h["no"], h["dim"], h["gain"] > h["loss"]) for h in got.history] == [
        (h["nq"], h["no"], h["dim"], h["gain"] > h["loss"]) for h in want.history]


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_refine_partition_matches_reference(fixture, mode):
    ds, wl, bank, jds, jwl, jbank, qe, qs = fixture
    prev = jpart.generate_bottom_clusters(jds, jwl, jbank, qe, qs, _cfg(jpart, 6), mode="batched").clusters
    wl2, jwl2 = make_workload(ds, m=16, dist="GAU", seed=4), jmake_workload(jds, m=16, dist="GAU", seed=4)
    qe2, qs2 = expand_queries(wl2, [], ds.vocab_size, use_itemsets=False)
    regressed = np.zeros(prev.k, bool)
    regressed[[0, prev.k - 1]] = True
    got = tpart.refine_partition(ds, wl2, bank, qe2, qs2, prev, regressed, _cfg(tpart), mode=mode)
    want = jpart.refine_partition(jds, jwl2, jbank, qe2, qs2, prev, regressed, _cfg(jpart), mode=mode)
    np.testing.assert_array_equal(got.clusters.assign, want.clusters.assign)
    np.testing.assert_array_equal(got.source, want.source)
    assert (got.n_refined, got.n_kept, got.n_splits, got.n_sgd_calls, got.n_dispatches) == (
        want.n_refined, want.n_kept, want.n_splits, want.n_sgd_calls, want.n_dispatches)
    assert got.n_splits > 0
