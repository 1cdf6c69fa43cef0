"""The port's narrow kNN level filter against the JAX package.

``ops.knn_level_dist_narrow`` takes one level's int16 MBR rank codes, its
coordinate dictionaries and its bitmaps, the int32 frontier and the batch's
packed query words (``pack_query_words``), and gathers for itself: the
default kNN descent makes no (M, F, Wp) word plane and no (M, F, 4) code
plane. On the CPU it runs its plain version, which is held here

* bit for bit against the port's and the reference's oracle
  ``knn_filter_narrow_ref`` on the planes gathered at the frontier, and
  against ``knn_level_dist`` on the f32 MBRs the codes came from;
* to 1 ulp against the reference's interpret-mode ``knn_filter_narrow``
  (its jitted distances are FMA-contracted on the CPU, ROADMAP §C);

over dirty ids, padding slots and rows, a query with no nonzero word, Wp of
1 and of W, N of 1 and one-entry dictionaries. ``_as_level``, which reads
gathered planes as one level of M*F nodes for ``knn_frontier_dist(_narrow)``
on the card, is held to the planes' oracles. The engine's narrow kNN descent
runs on ``knn_level_dist_narrow`` alone and equals the reference's
``retrieve_knn`` on ids, ``dist2`` (1 ulp) and every counter, and the host
oracle ``knn_query`` bit for bit. Inputs come from numpy with a seed (u32
words to JAX, their int32 views to the port).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro_torch.core.query import knn_query  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.serve.engine import retrieve_knn  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402

from test_torch_cases import (  # noqa: E402
    FRONTIER_SWEEP, KNN_ARGS, LEVEL_ARGS, LEVEL_NARROW_ARGS, LEVEL_NARROW_SWEEP,
    gathered_level_narrow, knn_case, level_narrow_case, packed_words, to_numpy, to_torch,
    wide_args,
)
from test_torch_knn import _same_knn, layout  # noqa: E402,F401  (layout: a fixture)
from test_torch_wordlist import _chip_smoke  # noqa: E402


def _narrow(case):
    return ops.knn_level_dist_narrow(*(to_torch(case[k]) for k in LEVEL_NARROW_ARGS))


# ---------------------------------------------------------------- kernel
@pytest.mark.parametrize("m,f,n,w,q_terms,single", LEVEL_NARROW_SWEEP)
def test_knn_level_dist_narrow_matches_reference(m, f, n, w, q_terms, single):
    case = level_narrow_case(np.random.default_rng(m * 7919 + f * 31 + n + w + 3), m, f, n, w,
                             q_terms, single)
    if single:
        assert case["dict_x"].size == case["dict_y"].size == 1
    got = _narrow(case)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, f)
    got = to_numpy(got)
    planes = gathered_level_narrow(case)
    np.testing.assert_array_equal(got, to_numpy(ref.knn_filter_narrow_ref(*map(to_torch, planes))))
    np.testing.assert_array_equal(got, np.asarray(jref.knn_filter_narrow_ref(*map(jnp.asarray,
                                                                                 planes))))
    np.testing.assert_array_equal(got, to_numpy(ops.knn_level_dist(*(to_torch(case[k])
                                                                       for k in LEVEL_ARGS))))
    np.testing.assert_array_max_ulp(got, np.asarray(jops.knn_frontier_dist_narrow(*planes)),
                                    maxulp=1)
    fr = case["frontier"]
    assert np.isinf(got[fr < 0]).all()  # padding slots
    if m > 1:
        assert np.isinf(got[0]).all()  # the query with no nonzero word
        assert np.isinf(got[-1]).all()  # a row of padding only
        assert np.isfinite(got[1:-1]).any()  # and others that hit
        assert (fr > n - 1).any()  # dirty ids, clamped
    if w > 4 and q_terms is None:
        assert case["q_wids"].shape[1] > 4  # past the packing's 4-word bucket
    case["frontier"] = np.full_like(fr, -1)  # an all-padding batch
    assert torch.isinf(_narrow(case)).all()


@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("m,f,w", FRONTIER_SWEEP)
def test_gathered_planes_read_as_one_level(m, f, w, narrow):
    """``_as_level``, which runs ``knn_frontier_dist(_narrow)`` on the
    card through the level kernels: the planes as M*F nodes with every
    plane word gives the planes' oracle distances bit for bit."""
    case, wide = knn_case(np.random.default_rng(m * 7919 + f * 31 + w + 5), m, f, w)
    if narrow:
        args = [to_torch(case[k]) for k in KNN_ARGS]
        q_pts, q_bits, f_codes, f_bm, f_valid, dict_x, dict_y = args
        want = ref.knn_filter_narrow_ref(*args)
    else:
        args = [to_torch(a) for a in wide_args(case, wide, "q_pts")]
        q_pts, q_bits, f_mbrs, f_bm, f_valid = args
        want = ref.knn_filter_ref(*args)
    frontier, wids = ops._as_level(f_valid, f_bm)
    assert frontier.dtype == wids.dtype == torch.int32
    assert torch.equal(frontier >= 0, f_valid > 0)
    n_nodes = m * f
    level_bms = f_bm.reshape(n_nodes, -1)
    if narrow:
        got = ops.knn_level_dist_narrow(q_pts, wids, q_bits, f_codes.reshape(n_nodes, 4),
                                        level_bms, frontier, dict_x, dict_y)
    else:
        got = ops.knn_level_dist(q_pts, wids, q_bits, f_mbrs.reshape(n_nodes, 4), level_bms,
                                 frontier)
    assert torch.equal(got, want)


def test_cpu_tensors_never_launch_the_narrow_level_kernel():
    _build.reset_launch_counts()
    case = level_narrow_case(np.random.default_rng(21), 4, 9, 5, 2)
    args = [to_torch(case[k]) for k in LEVEL_NARROW_ARGS]
    assert torch.equal(ops.knn_level_dist_narrow(*args), ref.knn_level_dist_narrow_ref(*args))
    kcase, _ = knn_case(np.random.default_rng(22), 3, 7, 2)
    kargs = [to_torch(kcase[k]) for k in KNN_ARGS]
    assert torch.equal(ops.knn_frontier_dist_narrow(*kargs), ref.knn_filter_narrow_ref(*kargs))
    assert not any(_build.launch_counts().values())


# --------------------------------------------------- the smoke's bound helper
def test_narrow_level_bound_counts_codes_and_dictionary_entries():
    """``chip_smoke.level_bound(..., narrow=True)`` on a hand-built level:
    the f32 count with each hit node's 16-byte MBR replaced by its 8 bytes
    of codes and the distinct dictionary entries those codes read."""
    cs = _chip_smoke()
    q = torch.tensor([[0, 0b101, 0, 0b10]], dtype=torch.int32)
    rows = torch.tensor([[5, 4, 0, 2],    # hits at words 1 and 3
                         [7, 2, 9, 1],    # misses: no bit shared
                         [1, 1, 1, 1]],   # would hit, but no slot holds it
                        dtype=torch.int32)
    wids, bits = packed_words(q.numpy().view(np.uint32))
    frontier = torch.tensor([[0, 1, -1]], dtype=torch.int32)
    codes = torch.tensor([[0, 1, 2, 1]] * 3, dtype=torch.int16)  # x: 0, 2; y: 1
    dict_x, dict_y = torch.tensor([0.0, 0.25, 0.5]), torch.tensor([0.0, 0.5])
    mbrs = torch.tensor([[0.0, 0.5, 0.5, 0.5]] * 3)
    args = (torch.zeros((1, 2)), wids, bits)
    wide, wide_ops = cs.level_bound((*args, mbrs, rows, frontier))
    nbytes, n_ops = cs.level_bound((*args, codes, rows, frontier, dict_x, dict_y), narrow=True)
    # one hit node: 16 bytes of MBR become 8 of codes and 3 dictionary entries
    assert nbytes == wide - 16 + 8 + 3 * 4
    assert n_ops == wide_ops == 3 + 11 + 3 * 2


# ----------------------------------------------------------------- engine
def _spy_narrow_level(monkeypatch):
    """Route ``ops.knn_level_dist_narrow`` through operand checks a CUDA
    launch would make (dtype, shape, contiguity), counting the calls, and
    make every other kNN filter, and the range filters on per-slot planes
    gathered at the frontier, fail if the narrow descent calls them."""
    calls = []
    real = ops.knn_level_dist_narrow

    def spy(q_pts, q_wids, q_bits, level_codes, level_bms, frontier, dict_x, dict_y):
        M, F = frontier.shape
        Wp = q_wids.shape[1]
        N, W = level_bms.shape
        dev = q_pts.device
        for name, t, dtype, shape in (
            ("q_pts", q_pts, torch.float32, (M, 2)), ("q_wids", q_wids, torch.int32, (M, Wp)),
            ("q_bits", q_bits, torch.int32, (M, Wp)),
            ("level_codes", level_codes, torch.int16, (N, 4)),
            ("level_bms", level_bms, torch.int32, (N, W)),
            ("frontier", frontier, torch.int32, (M, F)),
            ("dict_x", dict_x, torch.float32, (dict_x.shape[0],)),
            ("dict_y", dict_y, torch.float32, (dict_y.shape[0],)),
        ):
            ops._check(name, t, dtype, shape, dev)
        calls.append((M, F, Wp, W))
        return real(q_pts, q_wids, q_bits, level_codes, level_bms, frontier, dict_x, dict_y)

    def refuse(*a, **kw):
        raise AssertionError("the narrow kNN descent gathered per-slot planes")

    monkeypatch.setattr(ops, "knn_level_dist_narrow", spy)
    for name in ("knn_frontier_dist_narrow", "knn_frontier_dist", "knn_level_dist",
                 "filter_frontier_narrow", "filter_frontier"):
        monkeypatch.setattr(ops, name, refuse)
    return calls


@pytest.mark.parametrize("compact", [None, False])
@pytest.mark.parametrize("k", [1, 10])
def test_narrow_knn_descent_runs_on_the_level_kernel(monkeypatch, layout, k, compact):
    """The default kNN descent: every level of the probe and the sweep goes
    through ``knn_level_dist_narrow``; ids, ``dist2`` (1 ulp) and every
    counter equal the reference's ``retrieve_knn``, and ids and ``dist2``
    equal the host oracle ``knn_query`` bit for bit."""
    L = layout
    assert L["snap"].has_narrow_planes
    calls = _spy_narrow_level(monkeypatch)
    got = retrieve_knn(L["snap"], L["points"], L["bms"], k, plan_cache=PlanCache(),
                       compact=compact)
    assert len(calls) >= 2 * L["index"].height
    want = jengine.retrieve_knn(L["jsnap"], L["jpoints"], L["jbms"], k, plan_cache=JPlanCache(),
                                compact=compact)
    _same_knn(got, want)
    for q in range(L["points"].shape[0]):
        r = knn_query(L["index"], L["ds"], L["points"][q], L["bms"][q], k)
        row = got["ids"][q]
        np.testing.assert_array_equal(row[row >= 0], r.ids)
        np.testing.assert_array_equal(got["dist2"][q][: r.ids.size], r.dist2)
