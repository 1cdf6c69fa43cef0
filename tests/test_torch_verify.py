"""The port's SKR verification in every form against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions. Inputs
come from numpy with a seed (``test_torch_cases``) and go to both packages:
as ``uint32`` words to JAX, as their ``int32`` views to the port. Every
comparison is exact: verification only compares floats and ANDs words.

* Kernel layer: ``verify_candidates`` / ``verify_candidates_compact`` /
  ``fused_gather_verify`` equal the reference's Pallas wrappers (interpret
  mode) and oracles over ragged sweeps.
* Engine: ``retrieve`` equals the reference's ``retrieve`` on every key and
  dtype, and ``execute_serial``, for every ``fused`` x ``compact`` x
  ``fused_variant`` combination and on a snapshot without a compact bank
  (what a leaf dictionary above ``LEAF_DICT_MAX`` gives).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.serve import engine as jengine, snapshot as jsnapshot  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro_torch.core.query import execute_serial  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve_workload  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402

from test_torch_cases import (  # noqa: E402
    FUSED_SWEEP, VERIFY_ARGS, VERIFY_COMPACT_ARGS, VERIFY_COMPACT_SWEEP, VERIFY_SWEEP, fused_args,
    fused_case, fused_wide_args, to_numpy, to_torch, verify_case, verify_compact_case,
)
from test_torch_knn import _COMPACT, _SKR_KEYS, _same, _stripped  # noqa: E402
from test_torch_serving import _assert_matches_oracle, _pair  # noqa: E402


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("m,c,w", VERIFY_SWEEP)
def test_verify_candidates_matches_reference(m, c, w):
    case = verify_case(np.random.default_rng(m * 7919 + c * 31 + w), m, c, w)
    args = [case[k] for k in VERIFY_ARGS]
    got = ops.verify_candidates(*map(to_torch, args))
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, c)
    got = to_numpy(got)
    np.testing.assert_array_equal(got, np.asarray(jref.skr_verify_ref(*map(jnp.asarray, args))))
    np.testing.assert_array_equal(got, np.asarray(jops.verify_candidates(*args)))
    if m > 1:
        assert not got[-1].any()  # the all-invalid row


@pytest.mark.parametrize("m,t,obj,wl", VERIFY_COMPACT_SWEEP)
def test_verify_candidates_compact_matches_reference(m, t, obj, wl):
    case = verify_compact_case(np.random.default_rng(m * 7919 + t * 31 + obj + wl), m, t, obj, wl)
    args = [case[k] for k in VERIFY_COMPACT_ARGS]
    got = ops.verify_candidates_compact(*map(to_torch, args))
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, t * obj)
    got = to_numpy(got)
    np.testing.assert_array_equal(
        got, np.asarray(jref.skr_verify_compact_ref(*map(jnp.asarray, args))))
    np.testing.assert_array_equal(got, np.asarray(jops.verify_candidates_compact(*args)))
    if m > 1:
        assert got.any() and not got[-1].any()  # matches, and the all-invalid row


@pytest.mark.parametrize("variant", ["vmem", "prefetch", "auto"])
@pytest.mark.parametrize("m,t,k,obj,w,max_kw", FUSED_SWEEP)
def test_fused_gather_verify_matches_reference(variant, m, t, k, obj, w, max_kw):
    """The full-width fused verify (plain) vs the reference's fused kernel of
    the same variant (interpret) and its oracle; and the compact fused
    verify of the same case gives the same ids and counts."""
    case = fused_case(np.random.default_rng(m * 613 + t * 37 + k * 5 + obj + w + 3), m, t, k,
                      obj, w, max_kw)
    ids, kwv = ops.fused_gather_verify(*fused_wide_args(case), variant=variant)
    assert ids.dtype == kwv.dtype == torch.int32
    assert tuple(ids.shape) == (m, t * obj) and tuple(kwv.shape) == (m, t)
    jargs = [case[k] for k in ("q_rects", "q_bm", "top_leaf", "leaf_ok", "obj_x", "obj_y",
                               "obj_bm", "obj_id")]
    for eids, ekwv in (jops.fused_gather_verify(*jargs, variant=variant),
                       jref.fused_verify_ref(*map(jnp.asarray, jargs))):
        np.testing.assert_array_equal(to_numpy(ids), np.asarray(eids))
        np.testing.assert_array_equal(to_numpy(kwv), np.asarray(ekwv))
    cids, ckwv = ops.fused_gather_verify_compact(*fused_args(case), variant=variant)
    assert torch.equal(ids, cids) and torch.equal(kwv, ckwv)


@pytest.mark.parametrize("k,obj,w", [(1, 1, 1), (7832, 128, 256), (100, 64, 15)])
def test_leaf_bank_bytes_matches_reference(k, obj, w):
    assert ops.leaf_bank_bytes(k, obj, w) == jops.leaf_bank_bytes(k, obj, w)


def test_cpu_tensors_never_launch_the_verify_kernels():
    _build.reset_launch_counts()
    rng = np.random.default_rng(8)
    case = verify_case(rng, 4, 9, 2)
    args = [to_torch(case[k]) for k in VERIFY_ARGS]
    assert torch.equal(ops.verify_candidates(*args), ref.skr_verify_ref(*args))
    comp = verify_compact_case(rng, 3, 2, 5, 1)
    cargs = [to_torch(comp[k]) for k in VERIFY_COMPACT_ARGS]
    assert torch.equal(ops.verify_candidates_compact(*cargs), ref.skr_verify_compact_ref(*cargs))
    fargs = fused_wide_args(fused_case(rng, 3, 2, 4, 8, 2))
    for variant in ("auto", "vmem", "prefetch"):
        got = ops.fused_gather_verify(*fargs, variant=variant)
        assert all(torch.equal(a, b) for a, b in zip(got, ref.fused_verify_ref(*fargs)))
    with pytest.raises(ValueError, match="variant"):
        ops.fused_gather_verify(*fargs, variant="tiled")
    assert not any(_build.launch_counts().values())


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def layout():
    """An STR layout served by both packages, 20 MIX queries."""
    index, ds, jindex, jds = _pair("str", "sp", 2000, 7, leaf_size=32, fanout=4)
    return dict(index=index, ds=ds, wl=make_workload(ds, m=20, dist="MIX", seed=4),
                jwl=jmake_workload(jds, m=20, dist="MIX", seed=4),
                snap=IndexSnapshot.build(index, ds, device="cpu"),
                jsnap=jsnapshot.IndexSnapshot.build(jindex, jds), k=index.levels[-1].n)


_KNOBS = [  # (fused, compact, fused_variant)
    (None, False, None), (None, False, "vmem"), (None, False, "prefetch"),
    (False, None, None), (False, False, None), (False, None, "vmem"),
]


@pytest.mark.parametrize("fused,compact,variant", _KNOBS)
def test_verify_knobs_match_default_reference_and_oracle(layout, fused, compact, variant):
    L = layout
    kw = dict(fused=fused, compact=compact, fused_variant=variant)
    got = retrieve_workload(L["snap"], L["wl"], max_leaves=L["k"], plan_cache=PlanCache(), **kw)
    default = retrieve_workload(L["snap"], L["wl"], max_leaves=L["k"], plan_cache=PlanCache())
    _same(got, default, _SKR_KEYS)
    want = jengine.retrieve_workload(L["jsnap"], L["jwl"], max_leaves=L["k"],
                                     plan_cache=JPlanCache(), **kw)
    _same(got, want, _SKR_KEYS)
    _assert_matches_oracle(got, execute_serial(L["index"], L["ds"], L["wl"]))


@pytest.mark.parametrize("fused", [None, False])
def test_snapshot_without_compact_bank_matches_reference(layout, fused):
    L = layout
    snap, jsnap = _stripped(L["jsnap"], _COMPACT)
    assert not snap.has_compact_bank and snap.has_narrow_planes
    got = retrieve_workload(snap, L["wl"], max_leaves=L["k"], plan_cache=PlanCache(), fused=fused)
    default = retrieve_workload(L["snap"], L["wl"], max_leaves=L["k"], plan_cache=PlanCache())
    _same(got, default, _SKR_KEYS)
    _same(got, jengine.retrieve_workload(jsnap, L["jwl"], max_leaves=L["k"],
                                         plan_cache=JPlanCache(), fused=fused), _SKR_KEYS)
