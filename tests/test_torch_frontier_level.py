"""The port's range-descent frontier filters that read the level arrays
themselves, against the JAX package.

``ops.frontier_level`` (the f32 descent: f32 MBRs, or a live delta's widened
level arrays) and ``ops.frontier_level_narrow`` (the default descent: int16
MBR rank codes and the level's coordinate dictionaries) take one level's
arrays, the int32 frontier (-1 = empty slot, ids clamped to the level) and
the queries' (M, W) bitmap words, so the engine makes no per-slot plane and
packs no query word on the host for its descent. On the CPU they run their
plain versions, which are held here, bit for bit,

* against the reference's interpret-mode Pallas kernels
  ``filter_frontier`` / ``filter_frontier_narrow`` and its oracles on the
  planes gathered at the frontier (the narrow one on the packed words),
  and against each other on the MBRs the codes came from;

over dirty ids, padding slots and rows, a query with no nonzero word, a
rectangle that meets nothing, W of 1 and 3, N of 1 and one-entry
dictionaries, and an all-padding frontier. ``_as_level``, through which the
gathered-plane wrappers reach the same kernels on the card, is held to the
planes' oracles. The engine's SKR descents -- the default narrow one,
``quantized=False`` and with a ``DeltaBuffer`` -- run on the level functions
alone, ``n_levels`` times a descent, never on the gathered-plane wrappers or
the host packing, and equal the reference's ``retrieve`` on every key and
dtype. Inputs come from numpy with a seed (u32 words to JAX, their int32
views to the port).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.serve import engine as jengine, snapshot as jsnapshot  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402

from test_torch_cases import (  # noqa: E402
    FRONTIER_LEVEL_ARGS, FRONTIER_LEVEL_NARROW_ARGS, FRONTIER_LEVEL_ROUNDS, FRONTIER_LEVEL_SWEEP,
    frontier_level_case, gathered_frontier_level, to_numpy, to_torch,
)
from test_torch_delta import Pair  # noqa: E402
from test_torch_knn import _SKR_KEYS, _same  # noqa: E402
from test_torch_serving import _pair  # noqa: E402
from test_torch_wordlist import _chip_smoke  # noqa: E402


def _case(m, f, n, w, q_terms, single):
    return frontier_level_case(np.random.default_rng(m * 7919 + f * 31 + n + w + 11), m, f, n,
                               w, q_terms, single)


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("m,f,n,w,q_terms,single", FRONTIER_LEVEL_SWEEP)
def test_frontier_level_matches_reference(m, f, n, w, q_terms, single):
    """Both level filters equal the reference's Pallas kernels (interpret
    mode) and oracles on the planes gathered at the frontier, and each
    other; padding slots and rows, the query with no nonzero word and the
    rectangle that meets nothing survive nowhere."""
    case = _case(m, f, n, w, q_terms, single)
    if single:
        assert case["dict_x"].size == case["dict_y"].size == 1
    got = ops.frontier_level(*(to_torch(case[k]) for k in FRONTIER_LEVEL_ARGS))
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, f)
    narrow = ops.frontier_level_narrow(*(to_torch(case[k]) for k in FRONTIER_LEVEL_NARROW_ARGS))
    assert narrow.dtype == torch.int8 and tuple(narrow.shape) == (m, f)
    got, narrow = to_numpy(got), to_numpy(narrow)
    np.testing.assert_array_equal(narrow, got)
    wide, packed = gathered_frontier_level(case)
    np.testing.assert_array_equal(got, np.asarray(jops.filter_frontier(*wide)))
    np.testing.assert_array_equal(got, np.asarray(jref.frontier_filter_ref(*map(jnp.asarray, wide))))
    np.testing.assert_array_equal(narrow, np.asarray(jops.filter_frontier_narrow(*packed)))
    np.testing.assert_array_equal(
        narrow, np.asarray(jref.frontier_filter_narrow_ref(*map(jnp.asarray, packed))))
    fr = case["frontier"]
    assert not got[fr < 0].any()  # padding slots
    if m > 2:
        assert not got[0].any()  # the query with no nonzero word
        assert not got[1].any()  # the rectangle that meets nothing
        assert not got[-1].any()  # a row of padding only
        assert (fr > n - 1).any()  # dirty ids, clamped
    if w > 1 and n > 1:
        assert got.any()  # and slots that survive


def test_round_edge_case_has_survivors_decided_past_the_first_round():
    """The case the card's tests run the kernels' word compaction in two
    rounds on: survivors whose only hitting words lie past word 2,048, and
    survivors decided in the first round, equal to the reference."""
    case = _case(*FRONTIER_LEVEL_ROUNDS)
    got = to_numpy(ops.frontier_level(*(to_torch(case[k]) for k in FRONTIER_LEVEL_ARGS))) > 0
    wide, _ = gathered_frontier_level(case)
    np.testing.assert_array_equal(got, np.asarray(jref.frontier_filter_ref(*map(jnp.asarray,
                                                                                wide))) > 0)
    hits = (wide[3] & wide[1][:, None, :]) != 0  # (M, F, W)
    first, second = hits[..., :2048].any(-1), hits[..., 2048:].any(-1)
    assert (got & first).any() and (got & ~first & second).any()


@pytest.mark.parametrize("m,f,n,w,q_terms,single", FRONTIER_LEVEL_SWEEP[:3])
def test_all_padding_frontier_survives_nowhere(m, f, n, w, q_terms, single):
    case = _case(m, f, n, w, q_terms, single)
    case["frontier"] = np.full_like(case["frontier"], -1)
    for args in (FRONTIER_LEVEL_ARGS, FRONTIER_LEVEL_NARROW_ARGS):
        fn = ops.frontier_level if args is FRONTIER_LEVEL_ARGS else ops.frontier_level_narrow
        got = fn(*(to_torch(case[k]) for k in args))
        assert got.dtype == torch.int8 and not got.any()


@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("m,f,n,w,q_terms,single", FRONTIER_LEVEL_SWEEP)
def test_gathered_planes_read_as_one_level(m, f, n, w, q_terms, single, narrow):
    """``_as_level``, which runs ``filter_frontier(_narrow)`` on the card
    through the level kernels: the planes as M*F nodes (the packed words as
    the narrow one's bitmap) give the planes' oracle survivors bit for
    bit, and the wrappers equal the reference's kernels."""
    wide, packed = gathered_frontier_level(_case(m, f, n, w, q_terms, single))
    args = [to_torch(a) for a in (packed if narrow else wide)]
    q_rects, q_words, f_mbr, f_bm, f_valid = args[:5]
    frontier, _ = ops._as_level(f_valid, f_bm)
    assert frontier.dtype == torch.int32 and torch.equal(frontier >= 0, f_valid > 0)
    level = (q_rects, q_words, f_mbr.reshape(m * f, 4), f_bm.reshape(m * f, -1), frontier)
    if narrow:
        got = ops.frontier_level_narrow(*level, *args[5:])
        want = ops.filter_frontier_narrow(*args)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(jops.filter_frontier_narrow(*packed)))
    else:
        got = ops.frontier_level(*level)
        want = ops.filter_frontier(*args)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(jops.filter_frontier(*wide)))
    assert torch.equal(got, want)


def test_cpu_tensors_never_launch_the_frontier_level_kernels():
    _build.reset_launch_counts()
    case = _case(5, 37, 23, 3, None, False)
    args = [to_torch(case[k]) for k in FRONTIER_LEVEL_ARGS]
    assert torch.equal(ops.frontier_level(*args), ref.frontier_level_ref(*args))
    nargs = [to_torch(case[k]) for k in FRONTIER_LEVEL_NARROW_ARGS]
    assert torch.equal(ops.frontier_level_narrow(*nargs), ref.frontier_level_narrow_ref(*nargs))
    wide, packed = gathered_frontier_level(case)
    assert torch.equal(ops.filter_frontier(*map(to_torch, wide)),
                       ref.frontier_filter_ref(*map(to_torch, wide)))
    assert torch.equal(ops.filter_frontier_narrow(*map(to_torch, packed)),
                       ref.frontier_filter_narrow_ref(*map(to_torch, packed)))
    assert not any(_build.launch_counts().values())


def test_level_filters_reject_a_device_without_a_kernel():
    case = _case(5, 37, 23, 3, None, False)
    args = [to_torch(case[k]).to("meta") for k in FRONTIER_LEVEL_ARGS]
    with pytest.raises(ValueError, match="no kernel"):
        ops.frontier_level(*args)
    nargs = [to_torch(case[k]).to("meta") for k in FRONTIER_LEVEL_NARROW_ARGS]
    with pytest.raises(ValueError, match="no kernel"):
        ops.frontier_level_narrow(*nargs)


# --------------------------------------------------- the smoke's bound helper
def test_slot_bound_counts_the_level_form():
    """``chip_smoke.slot_bound`` on a hand-built level: the frontier in and
    the flags out for every slot; the MBR of each valid slot (16 bytes, or
    8 bytes of codes and the distinct dictionary entries they read); each
    node word that decides a slot whose MBR meets the rectangle, once; and
    the W words of each query with such a slot."""
    cs = _chip_smoke()
    q_bm = torch.tensor([[0, 0b101, 0, 0b10], [0, 0, 0, 0b1]], dtype=torch.int32)
    rows = torch.tensor([[5, 4, 0, 2],    # hits at words 1 and 3: the first decides
                         [7, 2, 9, 1],    # misses: words 1 and 3 decide
                         [1, 1, 1, 1]],   # hits query 1 at word 3
                        dtype=torch.int32)
    rects = torch.tensor([[0.0, 0.0, 1.0, 1.0], [2.0, 2.0, -2.0, -2.0]])  # the second meets nothing
    frontier = torch.tensor([[0, 1, -1, 7], [2, 0, -1, -1]], dtype=torch.int32)  # 7: dirty, node 2
    mbrs = torch.tensor([[0.0, 0.5, 0.5, 0.5]] * 3)
    codes = torch.tensor([[0, 1, 2, 1]] * 3, dtype=torch.int16)  # x: 0, 2; y: 1
    dict_x, dict_y = torch.tensor([0.0, 0.25, 0.5]), torch.tensor([0.0, 0.5])
    wide, wide_ops = cs.slot_bound((rects, q_bm, mbrs, rows, frontier), narrow=False)
    n_bytes, n_ops = cs.slot_bound((rects, q_bm, codes, rows, frontier, dict_x, dict_y),
                                   narrow=True)
    # 8 slots: ids in, flags out; 5 valid slots on 3 nodes, whose MBRs are
    # read once; query 0's slots meet: node 0 (word 1 decides), node 1
    # (words 1 and 3), node 2 (word 1) -- four node words -- and query 0's
    # 4 words; query 1 meets nothing; both queries' rectangles
    assert wide == 8 * 4 + 8 + 3 * 16 + 4 * 4 + 4 * 4 + 2 * 16
    # 8 bytes of codes a node, and dictionary entries x 0, 2 and y 1
    assert n_bytes == wide - 3 * 16 + 3 * 8 + 3 * 4
    assert n_ops == wide_ops == 8 + 5 * 4 + 4 * 2


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def layout():
    """A 3-level grid layout served by both packages, 20 MIX queries."""
    index, ds, jindex, jds = _pair("grid", "fs", 2500, 5, g=8, levels=3)
    wl = make_workload(ds, m=20, dist="MIX", seed=6)
    jwl = jmake_workload(jds, m=20, dist="MIX", seed=6)
    return dict(index=index, rects=wl.rects, bms=wl.kw_bitmap, jrects=jwl.rects,
                jbms=jwl.kw_bitmap, snap=IndexSnapshot.build(index, ds, device="cpu"),
                jsnap=jsnapshot.IndexSnapshot.build(jindex, jds))


def _spy_levels(monkeypatch):
    """Route both level filters through operand checks a CUDA launch would
    make (dtype, shape, contiguity), counting the calls by name, and make
    the gathered-plane wrappers and the host packing fail if a descent
    calls them."""
    calls = {"frontier_level": 0, "frontier_level_narrow": 0}

    def spy(name, real, n_mbr_cols, mbr_dtype):
        def run(q_rects, q_bm, level_mbr, level_bms, frontier, *dicts):
            M, F = frontier.shape
            N, W = level_bms.shape
            dev = q_rects.device
            for arg, t, dtype, shape in (
                ("q_rects", q_rects, torch.float32, (M, 4)), ("q_bm", q_bm, torch.int32, (M, W)),
                ("level_mbr", level_mbr, mbr_dtype, (N, n_mbr_cols)),
                ("level_bms", level_bms, torch.int32, (N, W)),
                ("frontier", frontier, torch.int32, (M, F)),
            ):
                ops._check(arg, t, dtype, shape, dev)
            for d in dicts:
                ops._check("dict", d, torch.float32, (d.shape[0],), dev)
            calls[name] += 1
            return real(q_rects, q_bm, level_mbr, level_bms, frontier, *dicts)
        return run

    def refuse(*a, **kw):
        raise AssertionError("the range descent gathered per-slot planes or packed words")

    monkeypatch.setattr(ops, "frontier_level",
                        spy("frontier_level", ops.frontier_level, 4, torch.float32))
    monkeypatch.setattr(ops, "frontier_level_narrow",
                        spy("frontier_level_narrow", ops.frontier_level_narrow, 4, torch.int16))
    for name in ("filter_frontier", "filter_frontier_narrow", "pack_query_words"):
        monkeypatch.setattr(ops, name, refuse)
    return calls


@pytest.mark.parametrize("quantized", [None, False])
def test_skr_descent_runs_on_the_level_filters(monkeypatch, layout, quantized):
    """The default narrow descent and the f32 one (``quantized=False``):
    one level-filter call per level, the other filter never, no host
    packing; every key and dtype equals the reference's ``retrieve``."""
    L = layout
    assert L["snap"].has_narrow_planes
    calls = _spy_levels(monkeypatch)
    for max_leaves in (4, L["index"].levels[-1].n):
        got = retrieve(L["snap"], L["rects"], L["bms"], max_leaves, plan_cache=PlanCache(),
                       quantized=quantized)
        want = jengine.retrieve(L["jsnap"], L["jrects"], L["jbms"], max_leaves,
                                plan_cache=JPlanCache(), quantized=quantized)
        _same(got, want, _SKR_KEYS)
    used, unused = (("frontier_level", "frontier_level_narrow") if quantized is False
                    else ("frontier_level_narrow", "frontier_level"))
    assert calls[used] == 2 * L["snap"].n_levels and calls[unused] == 0
    assert got["counts"].sum() > 0 and got["verified"].sum() > 0


@pytest.mark.parametrize("own_leaf_terms", [True, False])
def test_skr_descent_with_a_delta_runs_on_the_f32_level_filter(monkeypatch, own_leaf_terms):
    """A live delta: the f32 descent on the widened level arrays, one
    ``frontier_level`` call per level, equal to the reference on every key
    and dtype."""
    P = Pair(seed=3)
    P.churn(40, 30, own_leaf_terms)
    wl, jwl = P.workload(m=24)
    calls = _spy_levels(monkeypatch)
    got = P.skr(wl, jwl)
    assert calls["frontier_level"] == P.snap.n_levels and calls["frontier_level_narrow"] == 0
    assert got["counts"].sum() > 0


def test_full_width_tile_verify_still_packs_words(monkeypatch, layout):
    """The query-tile launch of the full-width fused verify is the one SKR
    stage that reads packed words; its batch packs them once, and the
    descent does not read them."""
    L = layout
    packs = []
    real = ops.pack_query_words
    monkeypatch.setattr(ops, "pack_query_words", lambda q: packs.append(1) or real(q))
    got = retrieve(L["snap"], L["rects"], L["bms"], 4, plan_cache=PlanCache(), compact=False,
                   fused_variant="vmem")
    want = jengine.retrieve(L["jsnap"], L["jrects"], L["jbms"], 4, plan_cache=JPlanCache(),
                            compact=False, fused_variant="vmem")
    _same(got, want, _SKR_KEYS)
    assert len(packs) == 1
