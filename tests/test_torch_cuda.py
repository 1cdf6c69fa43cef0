"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels build from
``src/repro_torch/kernels/csrc`` at first use) and skips elsewhere. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

All comparisons but one are exact: the range, verify, dense-filter and
subscription kernels only compare floats and AND words, and the kNN kernels
round each product and the sum on their own (``__fmul_rn``, ``__fadd_rn``),
as eager PyTorch does in the plain versions. The CDF-MLP bank sums its
products in another order than the plain version's matrix products and is
held to ``atol=2e-6`` on outputs in [0, 1], the reference's own tolerance.
Every comparison takes NaN as equal to NaN: the kernels of rows 1-10 and 12
also run at query rectangles and points with NaN and infinite coordinates
(``with_nonfinite``), and the CDF bank at NaN, infinite and far points.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.baselines.conventional import build_grid_index, build_str_rtree  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_update_stream, make_workload  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch.wisk_serve import serve_batch, serve_knn_batch  # noqa: E402
from repro_torch.serve.engine import retrieve_knn, retrieve_workload  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402
from repro_torch.serve.snapshot import IndexSnapshot  # noqa: E402

from repro_torch.core.types import ids_to_bitmap  # noqa: E402
from repro_torch.serve.delta import DeltaLog  # noqa: E402
from repro_torch.serve.subscribe import SubscriptionIndex  # noqa: E402

from test_torch_cases import (  # noqa: E402
    CDF_SWEEP, FILTER_ARGS, FILTER_LEVELS, FILTER_RAGGED, FILTER_SWEEP, FRONTIER_ARGS,
    FRONTIER_LEVEL_ARGS, FRONTIER_LEVEL_NARROW_ARGS, FRONTIER_LEVEL_SWEEP, FRONTIER_SWEEP,
    FUSED_SWEEP, KNN_ARGS, LEVEL_ARGS, LEVEL_NARROW_ARGS, LEVEL_NARROW_SWEEP, LEVEL_SWEEP,
    REMAP_ARGS, REMAP_SWEEP, SLOT_SWEEP, SUB_NAN_SWEEP, SUB_PAIRS_SWEEP, SUB_SWEEP, VERIFY_ARGS,
    VERIFY_COMPACT_ARGS, VERIFY_COMPACT_SWEEP, VERIFY_SWEEP, cdf_params, cdf_params_he, filter_case,
    with_edge_points, with_nonfinite,
    FRONTIER_LEVEL_ROUNDS, frontier_case, frontier_level_case, fused_args, fused_case,
    fused_wide_args, knn_case, late_word_case, level_case, level_narrow_case, nan_case, packed_words,
    rand_kw, rand_sub_rect, remap_case, slot_bank, sub_case, term_bitmaps, to_torch, verify_case,
    verify_compact_case, wide_args,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _equal(got, want):
    """Equal dtypes, shapes and values, a NaN equal to a NaN."""
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.is_floating_point():
            nan = torch.isnan(g)
            assert torch.equal(nan, torch.isnan(w))
            g, w = torch.where(nan, 0.0, g), torch.where(nan, 0.0, w)
        assert torch.equal(g, w)


def _nonfinite(case, key="q_rects"):
    """``case`` (a dict of numpy operands) with NaN and infinite coordinates
    written over some of its query rectangles or points (``key``)."""
    return {**case, key: with_nonfinite(case[key])}


@pytest.mark.parametrize("m,f,w", FRONTIER_SWEEP + [(1024, 64, 8)])
def test_frontier_narrow_kernel_matches_plain(cuda, m, f, w):
    case, _ = frontier_case(np.random.default_rng(m * 7919 + f * 31 + w), m, f, w)
    args = [to_torch(case[k], cuda) for k in FRONTIER_ARGS]
    before = _build.KERNELS["frontier_level_narrow"].launches
    got = ops.filter_frontier_narrow(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS["frontier_level_narrow"].launches == before + 1
    _equal(got, ref.frontier_filter_narrow_ref(*args))
    args = [to_torch(_nonfinite(case)[k], cuda) for k in FRONTIER_ARGS]
    _equal(ops.filter_frontier_narrow(*args), ref.frontier_filter_narrow_ref(*args))


def _fused_instance(instance, variant, case, device):
    """One compact fused-verify instance on a case: ``(run, plain, launch
    count name)``. "given": ``fused_gather_verify_compact`` on the query
    words ``remap_query_words`` gives; "remap": ``fused_verify_leaf_words``
    on the bitmaps and dictionaries, its remapped words returned too."""
    form = "tile" if variant == "vmem" else "slot"
    if instance == "given":
        args = fused_args(case, device)
        return (lambda: ops.fused_gather_verify_compact(*args, variant=variant),
                lambda: ref.fused_verify_compact_ref(*args), f"fused_verify_compact_{form}")
    args = [to_torch(case[k], device) for k in REMAP_ARGS]
    return (lambda: ops.fused_verify_leaf_words(*args, variant=variant, words=True),
            lambda: ref.fused_verify_leaf_words_ref(*args, words=True),
            f"fused_verify_remap_{form}")


@pytest.mark.parametrize("instance", ["given", "remap"])
@pytest.mark.parametrize("variant", ["vmem", "prefetch", "auto"])
@pytest.mark.parametrize("m,t,k,obj,w,max_kw", FUSED_SWEEP + [(1024, 32, 300, 128, 8, 6),
                                                           (64, 16, 40, 128, 16, 200)])
def test_fused_verify_kernel_matches_plain(cuda, variant, m, t, k, obj, w, max_kw, instance):
    """Both instances of rows 2 and 3 on encoded leaf banks: ids and kwv (and
    the remapping instance's words) bit for bit, one launch each."""
    case = fused_case(np.random.default_rng(m * 613 + t * 37 + k * 5 + obj + w), m, t, k, obj, w,
                      max_kw)
    run, plain, name = _fused_instance(instance, variant, case, cuda)
    _build.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert _build.KERNELS[name].launches == 1 and sum(_build.launch_counts().values()) == 1
    _equal(got, plain())
    run, plain, _ = _fused_instance(instance, variant, _nonfinite(case), cuda)
    _equal(run(), plain())


_REMAP_CARD = [  # m, t, k, obj, w, wl
    (1024, 32, 7832, 128, 256, 4),  # the SKR main path's shapes at the osm profile
    (5, 3, 4, 16, 5000, 2),         # query rows too wide to stage in the tile launch
    (3, 2, 2, 4, 3, 1024),          # the widest dictionaries (LEAF_DICT_MAX entries)
    (40, 9, 30, 300, 8, 3),         # OBJ past the (M, T) launch's 256 threads
]


@pytest.mark.parametrize("variant", ["vmem", "prefetch"])
@pytest.mark.parametrize("m,t,k,obj,w,wl", REMAP_SWEEP + _REMAP_CARD)
def test_fused_verify_remap_kernels_match_plain_ragged(cuda, variant, m, t, k, obj, w, wl):
    """The remapping instances on ragged dictionaries (``remap_case``): dirty
    leaf ids, ``leaf_ok = 0`` rows, entries past the bitmap, all-``-1``
    dictionaries, a query that meets no dictionary (no id, ``q_sig == 0``):
    ids, kwv and the words bit for bit, and words=False the same ids and
    counts."""
    case = remap_case(np.random.default_rng(m * 613 + t * 37 + k * 5 + obj + w + wl), m, t, k,
                      obj, w, wl)
    run, plain, _ = _fused_instance("remap", variant, case, cuda)
    got = run()
    torch.cuda.synchronize()
    _equal(got, plain())
    if m > 1:
        assert not got[3][0].any() and not (got[0][0] >= 0).any()
    args = [to_torch(case[k], cuda) for k in REMAP_ARGS]
    _equal(ops.fused_verify_leaf_words(*args, variant=variant), got[:2])
    run, plain, _ = _fused_instance("remap", variant, _nonfinite(case), cuda)
    _equal(run(), plain())


@pytest.mark.parametrize("m,f,w", FRONTIER_SWEEP + [(1024, 64, 8)])
def test_knn_filter_narrow_kernel_matches_plain(cuda, m, f, w):
    case, _ = knn_case(np.random.default_rng(m * 7919 + f * 31 + w + 1), m, f, w)
    args = [to_torch(case[k], cuda) for k in KNN_ARGS]
    before = _build.KERNELS["knn_level_dist_narrow"].launches
    got = ops.knn_frontier_dist_narrow(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS["knn_level_dist_narrow"].launches == before + 1
    _equal(got, ref.knn_filter_narrow_ref(*args))
    if m > 1:
        assert torch.isinf(got[-1]).all()  # the all-invalid row
    args = [to_torch(_nonfinite(case, "q_pts")[k], cuda) for k in KNN_ARGS]
    _equal(ops.knn_frontier_dist_narrow(*args), ref.knn_filter_narrow_ref(*args))


_WIDE = {  # query operand, wrapper, plain version, the kernel it launches
    "frontier_filter": ("q_rects", ops.filter_frontier, ref.frontier_filter_ref,
                        "frontier_level"),
    "knn_filter": ("q_pts", ops.knn_frontier_dist, ref.knn_filter_ref, "knn_level_dist"),
}


@pytest.mark.parametrize("kernel", list(_WIDE))
@pytest.mark.parametrize("m,f,w", FRONTIER_SWEEP + [(3, 33, 256), (256, 256, 256)])
def test_full_width_kernels_match_plain(cuda, kernel, m, f, w):
    """The f32 descent's filters on gathered planes against their plain
    versions, W = 1 to the osm profile's 256 words: filter_frontier through
    frontier_level's kernel and knn_frontier_dist through knn_level_dist's
    (the planes as one level of M*F nodes, all W query words)."""
    q, wrapper, plain, name = _WIDE[kernel]
    case, wide = knn_case(np.random.default_rng(m * 7919 + f * 31 + w + 2), m, f, w)
    args = [to_torch(a, cuda) for a in wide_args(case, wide, q)]
    before = _build.KERNELS[name].launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS[name].launches == before + 1
    _equal(got, plain(*args))
    args = [to_torch(a, cuda) for a in wide_args(_nonfinite(case, q), wide, q)]
    _equal(wrapper(*args), plain(*args))


@pytest.mark.parametrize("m,f,n,w,q_terms", LEVEL_SWEEP + [
    (37, 131, 53, 3, None),       # M and F off every block size; Wp = W
    (3, 257, 9, 1, None),         # W = Wp = 1
    (256, 2048, 1000, 256, 5),    # MIX-like queries at the osm width: Wp = 8
    (64, 8192, 7832, 256, 5),     # the leaf level's frontier width
])
def test_knn_level_dist_kernel_matches_plain(cuda, m, f, n, w, q_terms):
    """The f32 kNN descent's filter (one thread per slot, the gather inside
    the kernel, the query's packed words only) against its plain version:
    padding and dirty ids, a query with no nonzero word, a frontier of
    padding only, and an all-padding batch."""
    case = level_case(np.random.default_rng(m * 7919 + f * 31 + n + w), m, f, n, w, q_terms)
    args = [to_torch(case[k], cuda) for k in LEVEL_ARGS]
    before = _build.KERNELS["knn_level_dist"].launches
    got = ops.knn_level_dist(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS["knn_level_dist"].launches == before + 1
    _equal(got, ref.knn_level_dist_ref(*args))
    if m > 1:
        assert torch.isinf(got[0]).all() and torch.isinf(got[-1]).all()
        assert torch.isfinite(got).any()
    args[5] = torch.full_like(args[5], -1)
    assert torch.isinf(ops.knn_level_dist(*args)).all()
    args = [to_torch(_nonfinite(case, "q_pts")[k], cuda) for k in LEVEL_ARGS]
    _equal(ops.knn_level_dist(*args), ref.knn_level_dist_ref(*args))


@pytest.mark.parametrize("m,f,n,w,q_terms,single", LEVEL_NARROW_SWEEP + [
    (37, 131, 53, 3, None, False),     # M and F off every block size; Wp = W
    (3, 257, 9, 1, None, True),        # W = Wp = 1, one-entry dictionaries
    (256, 2048, 1000, 256, 5, False),  # MIX-like queries at the osm width: Wp = 8
    (64, 8192, 7832, 256, 5, False),   # the leaf level's frontier width
])
def test_knn_level_dist_narrow_kernel_matches_plain(cuda, m, f, n, w, q_terms, single):
    """The narrow kNN descent's filter (one thread per slot, the codes, the
    dictionaries and the node words read inside the kernel at the query's
    packed words) against its plain version and, bit for bit, against the
    f32 level kernel on the MBRs the codes came from: padding and dirty ids,
    a query with no nonzero word, a frontier of padding only, one-entry
    dictionaries, and an all-padding batch."""
    case = level_narrow_case(np.random.default_rng(m * 7919 + f * 31 + n + w + 3), m, f, n, w,
                             q_terms, single)
    args = [to_torch(case[k], cuda) for k in LEVEL_NARROW_ARGS]
    before = _build.KERNELS["knn_level_dist_narrow"].launches
    got = ops.knn_level_dist_narrow(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS["knn_level_dist_narrow"].launches == before + 1
    _equal(got, ref.knn_level_dist_narrow_ref(*args))
    _equal(got, ops.knn_level_dist(*(to_torch(case[k], cuda) for k in LEVEL_ARGS)))
    if m > 1:
        assert torch.isinf(got[0]).all() and torch.isinf(got[-1]).all()
        assert torch.isfinite(got).any()
    args[5] = torch.full_like(args[5], -1)
    assert torch.isinf(ops.knn_level_dist_narrow(*args)).all()
    nonfinite = _nonfinite(case, "q_pts")
    args = [to_torch(nonfinite[k], cuda) for k in LEVEL_NARROW_ARGS]
    got = ops.knn_level_dist_narrow(*args)
    _equal(got, ref.knn_level_dist_narrow_ref(*args))
    _equal(got, ops.knn_level_dist(*(to_torch(nonfinite[k], cuda) for k in LEVEL_ARGS)))


def test_knn_level_dist_narrow_checks_operands(cuda):
    case = level_narrow_case(np.random.default_rng(4), 4, 9, 5, 2)
    args = [to_torch(case[k], cuda) for k in LEVEL_NARROW_ARGS]
    bad = list(args)
    bad[3] = args[3].to(torch.int32)
    with pytest.raises(TypeError, match="level_codes"):
        ops.knn_level_dist_narrow(*bad)
    bad = list(args)
    bad[6] = args[6][:0]
    with pytest.raises(ValueError, match="empty coordinate dictionary"):
        ops.knn_level_dist_narrow(*bad)
    bad = list(args)
    bad[7] = args[7].cpu()
    with pytest.raises(ValueError, match="dict_y"):
        ops.knn_level_dist_narrow(*bad)


def test_knn_level_dist_checks_operands(cuda):
    case = level_case(np.random.default_rng(4), 4, 9, 5, 2)
    args = [to_torch(case[k], cuda) for k in LEVEL_ARGS]
    bad = list(args)
    bad[5] = args[5].long()
    with pytest.raises(TypeError, match="frontier"):
        ops.knn_level_dist(*bad)
    bad = list(args)
    bad[2] = args[2][:, :1].contiguous()
    with pytest.raises(ValueError, match="q_bits"):
        ops.knn_level_dist(*bad)
    bad = list(args)
    bad[4] = args[4].cpu()
    with pytest.raises(ValueError, match="level_bms"):
        ops.knn_level_dist(*bad)


_FRONTIER_LEVEL_CARD = [  # m, f, n, w, q_terms, single
    (37, 131, 53, 3, None, False),     # M and F off every block size, W = 3
    (64, 256, 7832, 256, 5, False),    # the leaf level's shape at the osm width
    (1024, 64, 991, 256, 5, False),    # a full batch at a narrow level
    FRONTIER_LEVEL_ROUNDS,             # W past one compaction round of 2,048 words
]


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("m,f,n,w,q_terms,single", FRONTIER_LEVEL_SWEEP + _FRONTIER_LEVEL_CARD)
def test_frontier_level_kernels_match_plain(cuda, m, f, n, w, q_terms, single, narrow):
    """The range descent's filters (one thread per slot, the level read
    inside the kernel, the node words at the query's nonzero words that
    the block compacts) against their plain versions, and the two
    instances against each other on the MBRs the codes came from: padding
    and dirty ids, a query with no nonzero word and one whose rectangle
    meets nothing, a frontier of padding only, one-entry dictionaries, W of
    1 to 2,100, and an all-padding batch."""
    case = frontier_level_case(np.random.default_rng(m * 7919 + f * 31 + n + w + 11), m, f, n,
                               w, q_terms, single)
    name = "frontier_level_narrow" if narrow else "frontier_level"
    keys = FRONTIER_LEVEL_NARROW_ARGS if narrow else FRONTIER_LEVEL_ARGS
    wrapper = getattr(ops, name)
    plain = ref.frontier_level_narrow_ref if narrow else ref.frontier_level_ref
    args = [to_torch(case[k], cuda) for k in keys]
    before = _build.KERNELS[name].launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS[name].launches == before + 1
    _equal(got, plain(*args))
    other = (ops.frontier_level(*(to_torch(case[k], cuda) for k in FRONTIER_LEVEL_ARGS)) if narrow
             else ops.frontier_level_narrow(*(to_torch(case[k], cuda)
                                              for k in FRONTIER_LEVEL_NARROW_ARGS)))
    _equal(got, other)
    if m > 2:
        assert not got[0].any() and not got[1].any() and not got[-1].any()
    if w > 1 and n > 1:
        assert got.any()
    args[4] = torch.full_like(args[4], -1)
    assert not wrapper(*args).any()
    args = [to_torch(_nonfinite(case)[k], cuda) for k in keys]
    _equal(wrapper(*args), plain(*args))


def test_frontier_level_checks_operands(cuda):
    case = frontier_level_case(np.random.default_rng(4), 4, 9, 5, 2)
    args = [to_torch(case[k], cuda) for k in FRONTIER_LEVEL_NARROW_ARGS]
    bad = list(args)
    bad[2] = args[2].to(torch.int32)
    with pytest.raises(TypeError, match="level_codes"):
        ops.frontier_level_narrow(*bad)
    bad = list(args)
    bad[5] = args[5][:0]
    with pytest.raises(ValueError, match="empty coordinate dictionary"):
        ops.frontier_level_narrow(*bad)
    wargs = [to_torch(case[k], cuda) for k in FRONTIER_LEVEL_ARGS]
    bad = list(wargs)
    bad[4] = wargs[4].long()
    with pytest.raises(TypeError, match="frontier"):
        ops.frontier_level(*bad)
    bad = list(wargs)
    bad[1] = wargs[1][:, :1].contiguous()
    with pytest.raises(ValueError, match="q_bm"):
        ops.frontier_level(*bad)
    bad = list(wargs)
    bad[3] = wargs[3].cpu()
    with pytest.raises(ValueError, match="level_bms"):
        ops.frontier_level(*bad)


@pytest.mark.parametrize("variant", ["vmem", "prefetch", "auto"])
@pytest.mark.parametrize("m,t,k,obj,w,max_kw", FUSED_SWEEP + [(13, 5, 11, 37, 3, 6),
                                                           (64, 16, 40, 128, 256, 6)])
def test_full_width_fused_verify_kernel_matches_plain(cuda, variant, m, t, k, obj, w, max_kw):
    case = fused_case(np.random.default_rng(m * 613 + t * 37 + k * 5 + obj + w + 3), m, t, k, obj,
                      w, max_kw)
    args = fused_wide_args(case, cuda)
    name = "fused_verify_tile" if variant == "vmem" else "fused_verify_slot"
    before = _build.KERNELS[name].launches
    got = ops.fused_gather_verify(*args, variant=variant)
    torch.cuda.synchronize()
    assert _build.KERNELS[name].launches == before + 1
    _equal(got, ref.fused_verify_ref(*args))
    args = fused_wide_args(_nonfinite(case), cuda)
    _equal(ops.fused_gather_verify(*args, variant=variant), ref.fused_verify_ref(*args))


@pytest.mark.parametrize("m,t,k,obj,w,max_kw", FUSED_SWEEP + [
    (13, 5, 11, 1, 1, 6),         # W = 1, one object a leaf
    (13, 5, 11, 37, 3, 6),        # W = 3, OBJ below the block
    (9, 7, 13, 200, 8, 6),        # OBJ above a warp multiple of it: 224 threads
    (5, 3, 7, 300, 16, 6),        # OBJ above the block: threads stride over the row
    (64, 16, 40, 128, 256, 6),    # the osm width
    (3, 2, 4, 37, 8192, 6),       # W at the wrapper's shared-memory ints: four rounds
    (4, 3, 5, 300, 2500, 6),      # two rounds of words and two passes over the row
    (1024, 32, 300, 128, 256, 6),  # the main path's M, T, OBJ and W
])
def test_fused_verify_slot_kernel_matches_plain(cuda, m, t, k, obj, w, max_kw):
    """The redesigned (M, T) launch (a block per (query, slot), a thread
    per object, the query's nonzero words compacted in the block) against
    its plain version: dirty leaf ids, invalid slots, -1 id pads, a query
    with no nonzero word, a NEVER_RECT query, and leaf_ok all 0."""
    rng = np.random.default_rng(m * 613 + t * 37 + k * 5 + obj + w + 29)
    case = fused_case(rng, m, t, k, obj, w, max_kw)
    case["top_leaf"].flat[0] = -1  # dirty leaf ids, clamped
    case["top_leaf"].flat[-1] = k + 1
    if m > 1:
        case["q_bm"][0] = 0
        case["q_rects"][-1] = ops.NEVER_RECT
    args = list(fused_wide_args(case, cuda))
    before = _build.KERNELS["fused_verify_slot"].launches
    got = ops.fused_gather_verify(*args, variant="prefetch")
    torch.cuda.synchronize()
    assert _build.KERNELS["fused_verify_slot"].launches == before + 1
    _equal(got, ref.fused_verify_ref(*args))
    if m > 1:
        assert not got[1][0].any() and not (got[0][0] >= 0).any()
        assert not (got[0][-1] >= 0).any()
    args[3] = torch.zeros_like(args[3])  # leaf_ok all 0
    ids, kwv = ops.fused_gather_verify(*args, variant="auto")
    assert (ids == -1).all() and not kwv.any()
    args = fused_wide_args(_nonfinite(case), cuda)
    _equal(ops.fused_gather_verify(*args, variant="prefetch"), ref.fused_verify_ref(*args))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("m,t,k,obj,w,max_kw", FUSED_SWEEP + [(13, 5, 11, 37, 3, 6),
                                                           (9, 7, 13, 45, 40, 6),
                                                           (64, 16, 40, 128, 256, 6),
                                                           (1024, 32, 300, 128, 256, 6)])
def test_fused_verify_tile_on_packed_words_matches_plain(cuda, m, t, k, obj, w, max_kw, sparse):
    """The redesigned query-tile launch (query tiles x slot chunks, one
    thread per object, rows read at the packed words) against its plain
    versions: dirty leaf ids, invalid slots, a NEVER_RECT query, a query
    with no nonzero word, Wp = 1 up to Wp = W, T and OBJ off the tiles."""
    rng = np.random.default_rng(m * 613 + t * 37 + k * 5 + obj + w + 17)
    case = fused_case(rng, m, t, k, obj, w, max_kw)
    if sparse:  # up to three of the bank's terms a query: Wp well below W
        held = np.flatnonzero(np.unpackbits(np.bitwise_or.reduce(
            case["obj_bm"].reshape(-1, w), axis=0).view(np.uint8), bitorder="little"))
        case["q_bm"] = term_bitmaps(rng, m, w, held, 1, 4)
    if m > 1:
        case["q_bm"][0] = 0
        case["q_rects"][-1] = ops.NEVER_RECT
    args = fused_wide_args(case, cuda)
    q_words = packed_words(case["q_bm"], cuda)
    before = _build.KERNELS["fused_verify_tile"].launches
    got = ops.fused_gather_verify(*args, variant="vmem", q_words=q_words)
    torch.cuda.synchronize()
    assert _build.KERNELS["fused_verify_tile"].launches == before + 1
    _equal(got, ref.fused_verify_packed_ref(args[0], *q_words, *args[2:]))
    _equal(got, ref.fused_verify_ref(*args))
    if m > 1:
        assert not got[1][0].any() and not (got[0][-1] >= 0).any()
    args = fused_wide_args(_nonfinite(case), cuda)
    _equal(ops.fused_gather_verify(*args, variant="vmem", q_words=q_words),
           ref.fused_verify_ref(*args))


@pytest.mark.parametrize("m,c,w", VERIFY_SWEEP + [(64, 4352, 256)])
def test_skr_verify_kernel_matches_plain(cuda, m, c, w):
    case = verify_case(np.random.default_rng(m * 7919 + c * 31 + w), m, c, w)
    args = [to_torch(case[k], cuda) for k in VERIFY_ARGS]
    before = _build.KERNELS["skr_verify"].launches
    got = ops.verify_candidates(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS["skr_verify"].launches == before + 1
    _equal(got, ref.skr_verify_ref(*args))
    args = [to_torch(_nonfinite(case)[k], cuda) for k in VERIFY_ARGS]
    _equal(ops.verify_candidates(*args), ref.skr_verify_ref(*args))


@pytest.mark.parametrize("m,t,obj,wl", VERIFY_COMPACT_SWEEP + [(1024, 32, 128, 4)])
def test_skr_verify_compact_kernel_matches_plain(cuda, m, t, obj, wl):
    case = verify_compact_case(np.random.default_rng(m * 7919 + t * 31 + obj + wl), m, t, obj, wl)
    args = [to_torch(case[k], cuda) for k in VERIFY_COMPACT_ARGS]
    before = _build.KERNELS["skr_verify_compact"].launches
    got = ops.verify_candidates_compact(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS["skr_verify_compact"].launches == before + 1
    _equal(got, ref.skr_verify_compact_ref(*args))
    args = [to_torch(_nonfinite(case)[k], cuda) for k in VERIFY_COMPACT_ARGS]
    _equal(ops.verify_candidates_compact(*args), ref.skr_verify_compact_ref(*args))


_SLOT_CARD = [  # m, t, k, b, w
    (1024, 32, 7832, 16, 256),  # log B's insert slots at the osm profile
    (1024, 32, 7832, 8, 4),     # log A's: Wl = 4
    (5, 3, 9, 16, 2100),        # two compaction rounds
    (64, 32, 300, 128, 256),    # T * B past one block pass many times
]


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("m,t,k,b,w", SLOT_SWEEP + _SLOT_CARD)
def test_skr_verify_slots_kernels_match_plain(cuda, m, t, k, b, w, compact):
    """The slot entries against their plain versions: ids, n_match and n_kw
    bit for bit, one launch each, and with every slot empty."""
    args = slot_bank(np.random.default_rng(m * 613 + t * 37 + k * 5 + b + w), m, t, k, b, w,
                     compact, cuda)
    entry, plain, name = ((ops.verify_slots_compact, ref.skr_verify_slots_compact_ref,
                           "skr_verify_slots_compact") if compact else
                          (ops.verify_slots, ref.skr_verify_slots_ref, "skr_verify_slots"))
    _build.reset_launch_counts()
    got = entry(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS[name].launches == 1 and sum(_build.launch_counts().values()) == 1
    _equal(got, plain(*args))
    if m > 2:
        assert not got[2][0] and not got[1][1]  # no query word; NEVER_RECT
    empty = args[:-1] + (torch.full_like(args[-1], -1),)
    got = entry(*empty)
    torch.cuda.synchronize()
    _equal(got, plain(*empty))
    assert not (got[0] >= 0).any() and not got[2].any()
    args = (to_torch(with_nonfinite(args[0].cpu().numpy()), cuda),) + args[1:]
    _equal(entry(*args), plain(*args))


@pytest.mark.parametrize("m,c,w", VERIFY_SWEEP + [(64, 4352, 256)])
def test_skr_verify_counted_kernel_matches_plain(cuda, m, c, w):
    """The unfused full-width verify's counted entry (the gathered planes as
    a bank of M rows, through row 10's kernel) against its plain version."""
    rng = np.random.default_rng(m * 7919 + c * 31 + w + 5)
    case = verify_case(rng, m, c, w)
    args = [to_torch(case[k], cuda) for k in VERIFY_ARGS[:5]]
    cid = to_torch(np.where(case["cand_valid"] > 0, rng.integers(0, 1 << 20, (m, c)), -1)
                   .astype(np.int32), cuda)
    before = _build.KERNELS["skr_verify"].launches
    got = ops.verify_candidates_counted(*args, cid)
    torch.cuda.synchronize()
    assert _build.KERNELS["skr_verify"].launches == before + 1
    top_leaf, leaf_ok = ops.identity_leaves(m, 1, cuda)
    _equal(got, ref.skr_verify_slots_ref(args[0], args[1], top_leaf, leaf_ok, *args[2:], cid))
    args[0] = to_torch(with_nonfinite(case["q_rects"]), cuda)
    _equal(ops.verify_candidates_counted(*args, cid),
           ref.skr_verify_slots_ref(args[0], args[1], top_leaf, leaf_ok, *args[2:], cid))


@pytest.mark.parametrize("m,t,obj,wl", VERIFY_COMPACT_SWEEP + [(1024, 32, 128, 4)])
def test_skr_verify_compact_counted_kernel_matches_plain(cuda, m, t, obj, wl):
    """The unfused compact verify's counted entry (the gathered planes as a
    bank of M*T rows, through row 9's kernel) against its plain version."""
    rng = np.random.default_rng(m * 7919 + t * 31 + obj + wl + 5)
    case = verify_compact_case(rng, m, t, obj, wl)
    args = [to_torch(case[k], cuda) for k in VERIFY_COMPACT_ARGS[:7]]
    cid = to_torch(np.where(case["cand_valid"] > 0, rng.integers(0, 1 << 20, (m, t * obj)), -1)
                   .astype(np.int32), cuda)
    before = _build.KERNELS["skr_verify_compact"].launches
    got = ops.verify_candidates_compact_counted(*args, cid)
    torch.cuda.synchronize()
    assert _build.KERNELS["skr_verify_compact"].launches == before + 1
    top_leaf, leaf_ok = ops.identity_leaves(m, t, cuda)
    bank = lambda a: a.reshape(m * t, obj, *a.shape[2:])  # noqa: E731
    _equal(got, ref.skr_verify_slots_compact_ref(*args[:3], top_leaf, leaf_ok,
                                                 *(bank(a) for a in args[3:]), bank(cid)))
    args[0] = to_torch(with_nonfinite(case["q_rects"]), cuda)
    _equal(ops.verify_candidates_compact_counted(*args, cid),
           ref.skr_verify_slots_compact_ref(*args[:3], top_leaf, leaf_ok,
                                            *(bank(a) for a in args[3:]), bank(cid)))


def test_slot_wrappers_check_operands(cuda):
    args = list(slot_bank(np.random.default_rng(4), 5, 3, 9, 16, 3, False, cuda))
    bad = list(args)
    bad[3] = args[3] > 0
    with pytest.raises(TypeError, match="leaf_ok"):
        ops.verify_slots(*bad)
    bad = list(args)
    bad[6] = args[6][:, :, :2].contiguous()
    with pytest.raises(ValueError, match="slot_bm"):
        ops.verify_slots(*bad)
    bad = list(args)
    bad[4] = args[4].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        ops.verify_slots(*bad)
    cargs = list(slot_bank(np.random.default_rng(5), 5, 3, 9, 16, 2, True, cuda))
    bad = list(cargs)
    bad[2] = cargs[2].cpu()
    with pytest.raises(ValueError, match="q_sig"):
        ops.verify_slots_compact(*bad)
    bad = list(cargs)
    bad[8] = cargs[8][:-1].contiguous()
    with pytest.raises(ValueError, match="slot_sig"):
        ops.verify_slots_compact(*bad)
    with pytest.raises(ValueError, match="empty slot bank"):
        ops.verify_slots(*args[:4], *(a[:0].contiguous() for a in args[4:]))


def test_verify_wrappers_check_operands(cuda):
    case = verify_case(np.random.default_rng(5), 4, 9, 2)
    args = [to_torch(case[k], cuda) for k in VERIFY_ARGS]
    bad = list(args)
    bad[4] = args[4][:, :, :1].contiguous()
    with pytest.raises(ValueError, match="cand_bm"):
        ops.verify_candidates(*bad)
    bad = list(args)
    bad[5] = args[5].to(torch.int32)
    with pytest.raises(TypeError, match="cand_valid"):
        ops.verify_candidates(*bad)
    comp = verify_compact_case(np.random.default_rng(6), 4, 3, 5, 2)
    cargs = [to_torch(comp[k], cuda) for k in VERIFY_COMPACT_ARGS]
    with pytest.raises(ValueError, match="leaf slots"):  # 14 candidates over T = 3 slots
        ops.verify_candidates_compact(*cargs[:3], *(a[:, :-1].contiguous() for a in cargs[3:]))
    bad = list(cargs)
    bad[2] = cargs[2].cpu()
    with pytest.raises(ValueError, match="q_sig"):
        ops.verify_candidates_compact(*bad)
    fcase = fused_case(np.random.default_rng(7), 3, 2, 4, 8, 2)
    fargs = list(fused_wide_args(fcase, cuda))
    fargs[6] = fargs[6].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="obj_bm"):
        ops.fused_gather_verify(*fargs)
    fargs = list(fused_wide_args(fcase, cuda))
    with pytest.raises(ValueError, match="variant"):
        ops.fused_gather_verify(*fargs, variant="tiled")
    fargs[1] = fargs[1][:, :1].contiguous()
    with pytest.raises(ValueError, match="obj_bm"):
        ops.fused_gather_verify(*fargs)
    fargs = list(fused_wide_args(fcase, cuda))
    wids, bits = packed_words(fcase["q_bm"], cuda)
    with pytest.raises(ValueError, match="q_bits"):
        ops.fused_gather_verify(*fargs, variant="vmem", q_words=(wids, bits[:1].contiguous()))
    with pytest.raises(TypeError, match="q_wids"):
        ops.fused_gather_verify(*fargs, variant="vmem", q_words=(wids.long(), bits))


def test_wrappers_check_operands(cuda):
    case, _ = frontier_case(np.random.default_rng(3), 4, 9, 2)
    args = [to_torch(case[k], cuda) for k in FRONTIER_ARGS]
    bad = list(args)
    bad[3] = args[3].to(torch.int64)
    with pytest.raises(TypeError, match="f_bm"):
        ops.filter_frontier_narrow(*bad)
    bad = list(args)
    bad[2] = args[2].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.filter_frontier_narrow(*bad)
    bad = list(args)
    bad[4] = args[4].cpu()
    with pytest.raises(ValueError, match="f_valid"):
        ops.filter_frontier_narrow(*bad)
    with pytest.raises(ValueError, match="q_rects"):
        ops.filter_frontier_narrow(args[0][:2], *args[1:])


def _refuse_remap(*a, **kw):
    raise AssertionError("a fused SKR batch called remap_query_words")


@pytest.mark.parametrize("layout", ["grid", "str"])
def test_engine_on_the_card_matches_the_plain_path(cuda, layout, monkeypatch):
    """Kernels on the card and the plain versions on the host serve the same
    index to identical outputs, key for key, and the card run launched both
    kernels: the compact fused verify's remapping instance, with
    ``remap_query_words`` refused."""
    monkeypatch.setattr(ops, "remap_query_words", _refuse_remap)
    ds = make_dataset("sp", n=3000, seed=4)
    index = build_grid_index(ds, 6) if layout == "grid" else build_str_rtree(ds, 32, 4)
    wl = make_workload(ds, m=40, dist="MIX", seed=5)
    host = serve_batch(IndexSnapshot.build(index, ds, device="cpu"), wl.rects, wl.kw_bitmap,
                       max_leaves=8, plan_cache=PlanCache())
    snap = IndexSnapshot.build(index, ds)  # default device: the card
    assert snap.device.type == "cuda"
    _build.reset_launch_counts()
    card = serve_batch(snap, wl.rects, wl.kw_bitmap, max_leaves=8, plan_cache=PlanCache())
    counts = _build.launch_counts()
    assert counts["frontier_level_narrow"] == index.height and counts["frontier_level"] == 0
    assert counts["fused_verify_remap_slot"] == 1 and counts["fused_verify_compact_slot"] == 0
    vmem = retrieve_workload(snap, wl, max_leaves=8, plan_cache=PlanCache(), fused_variant="vmem")
    assert _build.launch_counts()["fused_verify_remap_tile"] == 1
    assert _build.launch_counts()["fused_verify_compact_tile"] == 0
    for k in host:
        assert card[k].dtype == host[k].dtype
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)
        np.testing.assert_array_equal(vmem[k][: len(wl.rects)], host[k], err_msg=k)


def test_knn_engine_on_the_card_matches_the_plain_path(cuda):
    """kNN through the front door on the card (narrow and f32 descents) and
    the SKR f32 descent equal the plain path on the host, key for key, and
    each run launched its kernels."""
    ds = make_dataset("sp", n=3000, seed=4)
    index = build_str_rtree(ds, 32, 4)
    wl = make_workload(ds, m=40, dist="MIX", seed=5)
    points = np.stack([(wl.rects[:, 0] + wl.rects[:, 2]) / 2,
                       (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1).astype(np.float32)
    host_snap = IndexSnapshot.build(index, ds, device="cpu")
    snap = IndexSnapshot.build(index, ds)
    host = serve_knn_batch(host_snap, points, wl.kw_bitmap, 10, plan_cache=PlanCache())
    _build.reset_launch_counts()
    card = serve_knn_batch(snap, points, wl.kw_bitmap, 10, plan_cache=PlanCache())
    assert _build.launch_counts()["knn_level_dist_narrow"] >= 2 * index.height
    narrow = _build.launch_counts()["knn_level_dist_narrow"]
    wide = retrieve_knn(snap, points, wl.kw_bitmap, 10, plan_cache=PlanCache(), quantized=False)
    assert _build.launch_counts()["knn_level_dist"] >= 2 * index.height
    assert _build.launch_counts()["knn_level_dist_narrow"] == narrow
    for k in host:
        assert card[k].dtype == host[k].dtype
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)
        np.testing.assert_array_equal(wide[k][: len(points)], host[k], err_msg=k)
    skr_host = serve_batch(host_snap, wl.rects, wl.kw_bitmap, max_leaves=8, plan_cache=PlanCache())
    skr = retrieve_workload(snap, wl, max_leaves=8, plan_cache=PlanCache(), quantized=False)
    assert _build.launch_counts()["frontier_level"] == index.height
    for k in skr_host:
        np.testing.assert_array_equal(skr[k][: len(points)], skr_host[k], err_msg=k)


def test_knn_engine_at_nonfinite_points_matches_the_plain_path(cuda):
    """kNN at query points with NaN and infinite coordinates on the card
    (both descents) equals the plain path on the host, key for key: the
    distance kernels give NaN where the plain versions do."""
    ds = make_dataset("sp", n=3000, seed=4)
    index = build_str_rtree(ds, 32, 4)
    wl = make_workload(ds, m=40, dist="MIX", seed=5)
    points = with_nonfinite(np.stack([(wl.rects[:, 0] + wl.rects[:, 2]) / 2,
                                      (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1))
    host_snap = IndexSnapshot.build(index, ds, device="cpu")
    snap = IndexSnapshot.build(index, ds)
    for quantized, name in ((None, "knn_level_dist_narrow"), (False, "knn_level_dist")):
        host = retrieve_knn(host_snap, points, wl.kw_bitmap, 10, plan_cache=PlanCache(),
                            quantized=quantized)
        _build.reset_launch_counts()
        card = retrieve_knn(snap, points, wl.kw_bitmap, 10, plan_cache=PlanCache(),
                            quantized=quantized)
        assert _build.launch_counts()[name] >= 2 * index.height
        for k in host:
            assert card[k].dtype == host[k].dtype
            np.testing.assert_array_equal(card[k], host[k], err_msg=f"{quantized} {k}")
        assert (card["ids"][np.isfinite(points).all(1)] >= 0).any()


def _delta_log(index, ds, snap, own_leaf_terms, seed=3):
    """60 inserts near random objects, then 40 base and 2 buffered deletes."""
    log = DeltaLog(index, ds, snap)
    rng = np.random.default_rng(seed)
    vocab = (index.levels[-1].mbrs, snap.leaf_terms.cpu().numpy()) if own_leaf_terms else ()
    locs, kw = make_update_stream(ds, 60, rng, 0.01, *vocab)
    new = log.insert(locs, kw)
    log.delete(list(rng.choice(ds.n, 40, replace=False)) + [int(new[0]), int(new[-1])])
    return log


@pytest.mark.parametrize("own_leaf_terms", [True, False])
def test_delta_engine_on_the_card_matches_the_plain_path(cuda, own_leaf_terms, monkeypatch):
    """The same updates on the card and on the host: every verify knob and
    kNN serve identical outputs, and each card run launched its verify
    kernels -- the delta's insert slots on the compact words while every
    inserted term lies in its leaf's dictionary, else at full width; the
    fused knobs never run ``remap_query_words``."""
    remaps = []
    remap = ops.remap_query_words
    monkeypatch.setattr(ops, "remap_query_words", lambda *a: remaps.append(a) or remap(*a))
    ds = make_dataset("sp", n=3000, seed=4)
    index = build_str_rtree(ds, 32, 4)
    wl = make_workload(ds, m=40, dist="MIX", seed=5)
    points = np.stack([(wl.rects[:, 0] + wl.rects[:, 2]) / 2,
                       (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1).astype(np.float32)
    host_snap = IndexSnapshot.build(index, ds, device="cpu")
    snap = IndexSnapshot.build(index, ds)
    host_log = _delta_log(index, ds, host_snap, own_leaf_terms)
    log = _delta_log(index, ds, snap, own_leaf_terms)
    assert log.compact_ok == host_log.compact_ok == own_leaf_terms
    delta_kernel = "skr_verify_slots_compact" if own_leaf_terms else "skr_verify_slots"
    for kw, kernels in (
        (dict(), ("frontier_level", "fused_verify_remap_slot", delta_kernel)),
        (dict(fused_variant="vmem"), ("frontier_level", "fused_verify_remap_tile", delta_kernel)),
        (dict(fused=False), ("skr_verify_compact", delta_kernel)),
        (dict(compact=False), ("fused_verify_slot", "skr_verify_slots")),
        (dict(compact=False, fused_variant="vmem"), ("fused_verify_tile", "skr_verify_slots")),
        (dict(compact=False, fused=False), ("skr_verify", "skr_verify_slots")),
    ):
        host = retrieve_workload(host_snap, wl, max_leaves=8, plan_cache=PlanCache(),
                                 delta=host_log.buffer, **kw)
        _build.reset_launch_counts()
        remaps.clear()
        card = retrieve_workload(snap, wl, max_leaves=8, plan_cache=PlanCache(), delta=log.buffer,
                                 **kw)
        counts = _build.launch_counts()
        # the compact bank's words: remapped in the fused kernel, by
        # remap_query_words only for the unfused verify's gathered candidates
        assert len(remaps) == (kw == dict(fused=False)), (kw, len(remaps))
        assert counts["frontier_level_narrow"] == 0 and counts["frontier_level"] == index.height
        for name in kernels:
            assert counts[name] >= 1, (kw, name, counts)
        # the insert slots: one slot-entry launch on the delta's buffers
        assert counts["skr_verify_slots"] + counts["skr_verify_slots_compact"] == 1, (kw, counts)
        if "fused" not in kw:
            assert counts["skr_verify"] == counts["skr_verify_compact"] == 0, (kw, counts)
        for k in host:
            assert card[k].dtype == host[k].dtype
            np.testing.assert_array_equal(card[k], host[k], err_msg=f"{kw} {k}")
    host = serve_knn_batch(host_snap, points, wl.kw_bitmap, 10, plan_cache=PlanCache(),
                           delta=host_log.buffer)
    _build.reset_launch_counts()
    card = serve_knn_batch(snap, points, wl.kw_bitmap, 10, plan_cache=PlanCache(),
                           delta=log.buffer)
    assert _build.launch_counts()["knn_level_dist"] >= 2 * index.height
    assert _build.launch_counts()["knn_level_dist_narrow"] == 0
    for k in host:
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)


@pytest.mark.parametrize("m,k,w", FILTER_SWEEP + [(70, 7832, 3)] + FILTER_LEVELS)
def test_skr_filter_kernel_matches_plain(cuda, m, k, w):
    case = filter_case(np.random.default_rng(m * 7919 + k * 31 + w), m, k, w)
    args = [to_torch(case[a], cuda) for a in FILTER_ARGS]
    before = _build.KERNELS["skr_filter"].launches
    got = ops.filter_pairs(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS["skr_filter"].launches == before + 1
    _equal(got, ref.skr_filter_ref(*args))
    args = [to_torch(_nonfinite(case)[a], cuda) for a in FILTER_ARGS]
    _equal(ops.filter_pairs(*args), ref.skr_filter_ref(*args))


@pytest.mark.parametrize("m,k,w,sparse", FILTER_RAGGED + [(1024, 7832, 256, True)])
def test_skr_filter_every_tile_matches_plain(cuda, m, k, w, sparse):
    """The dense filter at its edges (node runs and strips, query tiles of 8
    cut short, rows not 16-byte aligned, W of 1 and 2,100, sparse words):
    one launch, equal to the plain version."""
    case = filter_case(np.random.default_rng(m * 7919 + k * 31 + w), m, k, w, sparse)
    args = [to_torch(case[a], cuda) for a in FILTER_ARGS]
    before = _build.KERNELS["skr_filter"].launches
    got = ops.filter_pairs(*args)
    torch.cuda.synchronize()
    assert _build.KERNELS["skr_filter"].launches == before + 1
    _equal(got, ref.skr_filter_ref(*args))
    args = [to_torch(_nonfinite(case)[a], cuda) for a in FILTER_ARGS]
    _equal(ops.filter_pairs(*args), ref.skr_filter_ref(*args))


def _pairs_sorted(pairs):
    """(n, 2) pairs on the host in (object, slot) order."""
    p = pairs.cpu()
    return p[torch.from_numpy(np.lexsort((p[:, 1].numpy(), p[:, 0].numpy())))]


@pytest.mark.parametrize("seed,n,s,v,obj_hi", SUB_PAIRS_SWEEP + [(5, 1000, 4099, 8192, 4)])
def test_sub_match_pairs_kernel_matches_plain(cuda, seed, n, s, v, obj_hi):
    """The pairs instance on the card, sorted, equals its plain version and
    the nonzero entries of the matrix instance; at capacity 0 and 1 it
    launches again at the exact count."""
    locs, okw, rects, kws = sub_case(np.random.default_rng(seed), n, s, v, obj_hi)
    args = [to_torch(a, cuda) for a in (locs, ids_to_bitmap(okw.astype(np.int32), v), rects,
                                        ids_to_bitmap(kws.astype(np.int32), v))]
    s_sig = ref.or_fold(args[3])
    plain, count = ref.sub_match_pairs_ref(*args, s_sig, 0)
    want = _pairs_sorted(ref.sub_match_pairs_ref(*args, s_sig, int(count))[0])
    kernel = _build.KERNELS["sub_match_pairs"]
    for cap in (None, 0, 1):
        before = kernel.launches
        got = ops.match_subscription_pairs(*args, s_sig, capacity=cap)
        torch.cuda.synchronize()
        retried = int(count) > (ops.SUB_PAIRS_CAPACITY if cap is None else cap)
        assert kernel.launches == before + 1 + retried
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        _equal(_pairs_sorted(got), want)
    mat = ops.match_subscriptions(locs, args[1], args[2], args[3])
    _equal(torch.nonzero(mat).to(torch.int32).cpu(), want)


@pytest.mark.parametrize("seed,n,s,v", SUB_NAN_SWEEP + [(10, 1000, 4099, 64)])
def test_sub_match_nan_coordinates_match_plain(cuda, seed, n, s, v):
    """NaN points (the x the tile is sorted by, the first object's among
    them) and NaN rectangle edges: both instances equal their plain
    versions, and no NaN point matches."""
    locs, okw, rects, kws = nan_case(np.random.default_rng(seed), n, s, v)
    obm = ids_to_bitmap(okw.astype(np.int32), v)
    sbm = ids_to_bitmap(kws.astype(np.int32), v)
    args = [to_torch(a, cuda) for a in (locs, obm, rects, sbm)]
    s_sig = ref.or_fold(args[3])
    _, count = ref.sub_match_pairs_ref(*args, s_sig, 0)
    want = _pairs_sorted(ref.sub_match_pairs_ref(*args, s_sig, int(count))[0])
    assert int(count) > 0 and not np.isnan(locs[want[:, 0].numpy()]).any()
    _equal(_pairs_sorted(ops.match_subscription_pairs(*args, s_sig)), want)
    mat = ops.match_subscriptions(locs, obm, args[2], args[3], s_sig)
    _equal(mat.cpu(), ops.match_subscriptions(locs, obm, to_torch(rects), to_torch(sbm)))


@pytest.mark.parametrize("n,s,w", [(40, 60, 40), (1000, 4099, 256)])
def test_sub_match_pairs_past_the_staged_words(cuda, n, s, w):
    """Matches decided only by words past an object's 32 staged pairs."""
    args = [to_torch(a, cuda) for a in late_word_case(np.random.default_rng(n + s + w), n, s, w)]
    s_sig = ref.or_fold(args[3])
    _, count = ref.sub_match_pairs_ref(*args, s_sig, 0)
    assert int(count) > 0
    want = _pairs_sorted(ref.sub_match_pairs_ref(*args, s_sig, int(count))[0])
    _equal(_pairs_sorted(ops.match_subscription_pairs(*args, s_sig)), want)


@pytest.mark.parametrize("seed,n,s,v", SUB_SWEEP + [(5, 1000, 4099, 8192)])
def test_sub_match_kernel_matches_plain(cuda, seed, n, s, v):
    """The kernel on the packed operands against the packed plain version,
    the full-width plain version and the host run of the same wrapper."""
    locs, okw, rects, kws = sub_case(np.random.default_rng(seed), n, s, v)
    obm = ids_to_bitmap(okw.astype(np.int32), v)
    sbm = ids_to_bitmap(kws.astype(np.int32), v)
    before = _build.KERNELS["sub_match"].launches
    got = ops.match_subscriptions(locs, obm, to_torch(rects, cuda), to_torch(sbm, cuda))
    torch.cuda.synchronize()
    assert _build.KERNELS["sub_match"].launches == before + 1
    _equal(got.cpu(), ops.match_subscriptions(locs, obm, to_torch(rects), to_torch(sbm)))
    _equal(got, ref.sub_match_ref(*(to_torch(a, cuda) for a in (locs, obm, rects, sbm))))


# the kernel's tiles: 8 models a block (one a warp), 32 P points a step (P =
# 4, 2, 1 at H <= 8, 16, 32) in strips of 2,048 points; these banks at the
# He scale of the smoke's (cdf_params_he), the others at the reference
# test's scales
_CDF_CARD = [(n, b, h, True) for h in ops.CDF_HIDDEN_WIDTHS for n, b in (
    (1, 1),        # one point, one model
    (4099, 7),     # one model below the tile; two strips and a ragged one
    (2081, 8),     # the tile; a strip and 33 points
    (97, 9),       # one model above it; a step cut short
    (5000, 196),   # the smoke's bank width
)]


@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("n,b,h,he", [c + (False,) for c in CDF_SWEEP]
                         + [(100_000, 37, 16, False), (4099, 3, 4, False)] + _CDF_CARD)
def test_cdf_mlp_kernel_matches_plain(cuda, n, b, h, he, edges):
    """The bank on the card against its plain version to ``atol=2e-6``, at
    every hidden width, B off and on the 8-model tile, N off the point
    tiles; ``edges``: with ``CDF_EDGE_X`` (NaN, infinite and far points)
    written over some points, NaN where the plain version gives NaN."""
    rng = np.random.default_rng(n + b + h)
    params = ops.cdf_params_from_reference((cdf_params_he if he else cdf_params)(rng, b, h))
    assert params["w0"].device.type == "cuda"
    x = rng.uniform(0, 1, n).astype(np.float32)
    x = torch.from_numpy(with_edge_points(rng, x) if edges else x).to(cuda)
    before = _build.KERNELS["cdf_mlp_bank"].launches
    got = ops.cdf_bank_forward(params, x)
    torch.cuda.synchronize()
    assert _build.KERNELS["cdf_mlp_bank"].launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, b)
    torch.testing.assert_close(got, ref.cdf_mlp_ref(params, x), atol=2e-6, rtol=0, equal_nan=True)
    assert torch.isnan(got[torch.isnan(x)]).all()
    assert not torch.isnan(got[torch.isfinite(x)]).any()


def test_new_wrappers_check_operands(cuda):
    case = filter_case(np.random.default_rng(2), 4, 9, 2)
    args = [to_torch(case[a], cuda) for a in FILTER_ARGS]
    with pytest.raises(ValueError, match="n_bm"):
        ops.filter_pairs(*args[:3], args[3][:, :1].contiguous())
    # no cap on W: 2,048 words run, and equal the plain version
    wide = filter_case(np.random.default_rng(2), 4, 9, 2048)
    wide = [to_torch(wide[a], cuda) for a in FILTER_ARGS]
    _equal(ops.filter_pairs(*wide), ref.skr_filter_ref(*wide))
    with pytest.raises(ValueError, match="aligned"):
        ops.filter_pairs(args[0].reshape(-1)[1:13].reshape(3, 4), args[1][:3], *args[2:])
    params = ops.cdf_params_from_reference(cdf_params(np.random.default_rng(3), 2, 12))
    with pytest.raises(ValueError, match="hidden width"):
        ops.cdf_bank_forward(params, torch.zeros(5, device=cuda))
    params = ops.cdf_params_from_reference(cdf_params(np.random.default_rng(3), 2, 8))
    with pytest.raises(TypeError, match="x"):
        ops.cdf_bank_forward(params, torch.zeros(5, dtype=torch.float64, device=cuda))


def test_leaf_words_wrapper_checks_operands(cuda):
    """``fused_verify_leaf_words`` refuses what its kernels do not take."""
    case = remap_case(np.random.default_rng(8), 5, 3, 4, 8, 2, 2)
    args = [to_torch(case[k], cuda) for k in REMAP_ARGS]
    bad = list(args)
    bad[1] = args[1].to(torch.int64)
    with pytest.raises(TypeError, match="q_bm"):
        ops.fused_verify_leaf_words(*bad)
    bad = list(args)
    bad[2] = args[2][:, :32].contiguous()  # one dictionary word for Wl = 2
    with pytest.raises(ValueError, match="leaf_terms"):
        ops.fused_verify_leaf_words(*bad)
    bad = list(args)
    bad[3] = args[3].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_verify_leaf_words(*bad)
    bad = list(args)
    bad[8] = args[8].cpu()
    with pytest.raises(ValueError, match="obj_sig"):
        ops.fused_verify_leaf_words(*bad)
    with pytest.raises(ValueError, match="variant"):
        ops.fused_verify_leaf_words(*args, variant="tiled")
    with pytest.raises(ValueError, match="at least one word"):
        ops.fused_verify_leaf_words(args[0], args[1][:, :0].contiguous(), *args[2:])
    wide = remap_case(np.random.default_rng(9), 2, 2, 2, 4, 1, 1025)  # past LEAF_DICT_MAX
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_verify_leaf_words(*(to_torch(wide[k], cuda) for k in REMAP_ARGS),
                                    variant="vmem")


def test_fused_batches_launch_the_remapping_instance(cuda, monkeypatch):
    """``serve_batch`` on the compact bank, alone and with a log-A-like
    delta (compact insert bitmaps), with ``fused_variant`` "auto" and
    "vmem": one launch of the remapping instance per batch, none of the
    given-words one, ``remap_query_words`` refused; equal to the host."""
    monkeypatch.setattr(ops, "remap_query_words", _refuse_remap)
    ds = make_dataset("sp", n=3000, seed=6)
    index = build_str_rtree(ds, 32, 4)
    wl = make_workload(ds, m=40, dist="MIX", seed=7)
    host_snap = IndexSnapshot.build(index, ds, device="cpu")
    snap = IndexSnapshot.build(index, ds)
    host_log = _delta_log(index, ds, host_snap, True, seed=5)
    log = _delta_log(index, ds, snap, True, seed=5)
    assert log.buffer.ins_cbm is not None
    for delta, host_delta in ((None, None), (log.buffer, host_log.buffer)):
        for variant, name in (("auto", "fused_verify_remap_slot"),
                              ("vmem", "fused_verify_remap_tile")):
            host = retrieve_workload(host_snap, wl, max_leaves=8, plan_cache=PlanCache(),
                                     delta=host_delta, fused_variant=variant)
            _build.reset_launch_counts()
            card = retrieve_workload(snap, wl, max_leaves=8, plan_cache=PlanCache(), delta=delta,
                                     fused_variant=variant)
            counts = _build.launch_counts()
            assert counts[name] == 1, (variant, counts)
            assert counts["fused_verify_compact_slot"] == counts["fused_verify_compact_tile"] == 0
            assert counts["skr_verify_slots_compact"] == (delta is not None), counts
            for k in host:
                np.testing.assert_array_equal(card[k], host[k], err_msg=f"{variant} {k}")


def test_dense_engine_on_the_card_matches_the_plain_path(cuda):
    """The dense scan (one ``skr_filter`` launch per level) through the
    front door on the card, with and without a delta, equals the host."""
    ds = make_dataset("sp", n=3000, seed=4)
    index = build_str_rtree(ds, 32, 4)
    wl = make_workload(ds, m=40, dist="MIX", seed=5)
    host_snap = IndexSnapshot.build(index, ds, device="cpu", dense=True)
    snap = IndexSnapshot.build(index, ds, dense=True)
    host = serve_batch(host_snap, wl.rects, wl.kw_bitmap, max_leaves=8, mode="dense")
    _build.reset_launch_counts()
    card = serve_batch(snap, wl.rects, wl.kw_bitmap, max_leaves=8, mode="dense")
    counts = _build.launch_counts()
    assert counts["skr_filter"] == index.height and counts["frontier_level_narrow"] == 0
    assert counts["fused_verify_remap_slot"] == 1 and counts["fused_verify_compact_slot"] == 0
    for k in host:
        assert card[k].dtype == host[k].dtype
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)
    host_log = _delta_log(index, ds, host_snap, True)
    log = _delta_log(index, ds, snap, True)
    host = retrieve_workload(host_snap, wl, max_leaves=8, mode="dense", delta=host_log.buffer)
    card = retrieve_workload(snap, wl, max_leaves=8, mode="dense", delta=log.buffer)
    for k in host:
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)


def test_subscription_index_on_the_card_matches_the_host(cuda):
    """Subscription churn and arrivals through a ``DeltaLog`` on the card
    (``match_arrivals`` and ``pump``) give the host's stream, and the card
    runs launched the pairs instance ``sub_match_pairs``, once a match,
    and never the matrix instance."""
    ds = make_dataset("sp", n=3000, seed=4)
    index = build_str_rtree(ds, 32, 4)
    rng = np.random.default_rng(9)
    idx, host = SubscriptionIndex(ds.vocab_size), SubscriptionIndex(ds.vocab_size, device="cpu")
    pumped = SubscriptionIndex(ds.vocab_size)
    assert idx.block().rects.device.type == "cuda"
    log = DeltaLog(index, ds, IndexSnapshot.build(index, ds))
    subs = [(rand_sub_rect(rng), rand_kw(rng, ds.vocab_size, lo=1)) for _ in range(300)]
    subs += [((0.0, 0.0, 1.0, 1.0), [int(np.argmax(ds.kw_freq))])]
    for r, kw in subs:
        for i in (idx, host, pumped):
            i.subscribe(r, kw)
    _build.reset_launch_counts()
    for step in range(4):
        locs, kw = make_update_stream(ds, 50, rng, 0.02)
        ids = log.insert(locs, kw)
        idx.match_arrivals(ids, locs, kw_ids=kw)
        host.match_arrivals(ids, locs, kw_ids=kw)
        pumped.pump(log)
        if step == 1:
            for sid in range(0, 300, 7):
                for i in (idx, host, pumped):
                    i.unsubscribe(sid)
    assert _build.launch_counts()["sub_match_pairs"] == 8
    assert _build.launch_counts()["sub_match"] == 0
    got = idx.drain()
    assert got.shape[0] > 0
    np.testing.assert_array_equal(got, host.drain())
    np.testing.assert_array_equal(got, pumped.drain())
    assert idx.pump(log) == 0
