"""The port's kernel layer (``repro_torch.kernels``) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; each is
held against the reference's jnp oracle (``repro.kernels.ref``), the
reference's Pallas wrapper in interpret mode (``repro.kernels.ops``), and
the f32/full-width oracle the narrow and compact encodings must agree
with. Inputs come from numpy with a seed (``test_torch_cases``) and go to both
packages: as ``uint32`` words to JAX, as their ``int32`` views to the port.
Every comparison is exact -- nothing on this path does float arithmetic.
The CUDA kernels themselves are tested on the card (test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.serve.snapshot import encode_leaf_vocab  # noqa: E402

from test_torch_cases import (  # noqa: E402
    FRONTIER_ARGS, FRONTIER_SWEEP, FUSED_SWEEP, frontier_case, fused_args, fused_case,
    to_numpy, to_torch, words,
)


@pytest.mark.parametrize("m,f,w", FRONTIER_SWEEP)
def test_frontier_narrow_matches_reference(m, f, w):
    """Port (plain) vs the reference oracle, its Pallas kernel (interpret),
    and the f32 full-width predicate: bit-identical survivor masks."""
    case, (qb, f_mbrs, f_bm_full) = frontier_case(np.random.default_rng(m * 7919 + f * 31 + w), m, f, w)
    args = [case[k] for k in FRONTIER_ARGS]
    got = ops.filter_frontier_narrow(*[to_torch(a) for a in args])
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, f)
    got = to_numpy(got)
    np.testing.assert_array_equal(got, np.asarray(jref.frontier_filter_narrow_ref(*map(jnp.asarray, args))))
    np.testing.assert_array_equal(got, np.asarray(jops.filter_frontier_narrow(*args)))
    wide = jref.frontier_filter_ref(*map(jnp.asarray, (case["q_rects"], qb, f_mbrs, f_bm_full, case["f_valid"])))
    np.testing.assert_array_equal(got, np.asarray(wide))


def _reference_compact(case):
    """The reference's own remap of the same case (u32 words)."""
    q_cbm, q_sig = jops.remap_query_words(
        jnp.asarray(case["q_bm"]), jnp.asarray(case["leaf_terms"]), jnp.asarray(case["top_leaf"]))
    return (case["q_rects"], q_cbm, q_sig, case["top_leaf"], case["leaf_ok"], case["obj_x"],
            case["obj_y"], case["obj_cbm"], case["obj_sig"], case["obj_id"])


@pytest.mark.parametrize("variant", ["vmem", "prefetch", "auto"])
@pytest.mark.parametrize("m,t,k,obj,w,max_kw", FUSED_SWEEP)
def test_fused_verify_matches_reference(variant, m, t, k, obj, w, max_kw):
    """Port (plain) vs the reference's fused compact kernel of the same
    variant (interpret), its compact oracle, and the full-width oracle:
    the same ids in the same slots and the same per-slot Eq. 1 counts."""
    case = fused_case(np.random.default_rng(m * 613 + t * 37 + k * 5 + obj + w), m, t, k, obj, w,
                      max_kw)
    assert (case["obj_cbm"].shape[2] > 1) == (max_kw > 32)
    ids, kwv = ops.fused_gather_verify_compact(*fused_args(case), variant=variant)
    assert ids.dtype == kwv.dtype == torch.int32
    assert tuple(ids.shape) == (m, t * obj) and tuple(kwv.shape) == (m, t)
    jargs = _reference_compact(case)
    for eids, ekwv in (
        jops.fused_gather_verify_compact(*jargs, variant=variant),
        jref.fused_verify_compact_ref(*map(jnp.asarray, jargs)),
        jref.fused_verify_ref(*map(jnp.asarray, (
            case["q_rects"], case["q_bm"], case["top_leaf"], case["leaf_ok"], case["obj_x"],
            case["obj_y"], case["obj_bm"], case["obj_id"]))),
    ):
        np.testing.assert_array_equal(to_numpy(ids), np.asarray(eids))
        np.testing.assert_array_equal(to_numpy(kwv), np.asarray(ekwv))


def _wide_dictionary_case(rng, m, t, k, obj, w, per_obj=16, pool=64):
    """Leaves whose dictionaries hold ~``pool`` terms, so remapped local
    words reach bit 31; the last query's bitmap is all ones."""
    ob = np.zeros((k, obj, w), np.uint32)
    for c in range(k):
        terms = rng.choice(32 * w, size=min(pool, 32 * w), replace=False)
        for o in range(obj):
            picks = rng.choice(terms, size=min(per_obj, terms.size), replace=False)
            np.bitwise_or.at(ob[c, o], picks >> 5, np.uint32(1) << (picks & 31).astype(np.uint32))
    lt, _, _ = encode_leaf_vocab(ob)
    q_bm = words(rng, m, w)
    q_bm[-1] = np.uint32(0xFFFFFFFF)
    return q_bm, lt, rng.integers(-1, k + 2, (m, t)).astype(np.int32)


@pytest.mark.parametrize("m,t,k,obj,w", [(1, 1, 1, 1, 1), (5, 3, 9, 16, 3), (9, 8, 6, 64, 15), (4, 2, 3, 32, 8)])
def test_remap_query_words_matches_reference(m, t, k, obj, w):
    """The torch remap (int32 views) equals the reference's u32 remap bit
    for bit -- local bit 31 included -- with dirty leaf ids clamped alike."""
    q_bm, lt, leaves = _wide_dictionary_case(np.random.default_rng(k * 101 + w), m, t, k, obj, w)
    q_cbm, q_sig = ops.remap_query_words(to_torch(q_bm), to_torch(lt), to_torch(leaves))
    e_cbm, e_sig = jops.remap_query_words(jnp.asarray(q_bm), jnp.asarray(lt), jnp.asarray(leaves))
    assert q_cbm.dtype == q_sig.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(q_cbm, e_cbm), np.asarray(e_cbm))
    np.testing.assert_array_equal(to_numpy(q_sig, e_sig), np.asarray(e_sig))
    if lt.shape[1] >= 32 and (lt[:, 31] >= 0).any():
        assert (q_cbm < 0).any(), "the case must set a local bit 31"


@pytest.mark.parametrize("m,w,seed", [(1, 1, 0), (7, 15, 1), (16, 15, 2), (5, 32, 3), (9, 256, 4)])
def test_pack_query_words_matches_reference(m, w, seed):
    q = words(np.random.default_rng(seed), m, w)
    wids, bits = ops.pack_query_words(q)
    ewids, ebits = jops.pack_query_words(q)
    assert wids.dtype == np.int32 and bits.dtype == np.uint32
    np.testing.assert_array_equal(wids, np.asarray(ewids))
    np.testing.assert_array_equal(bits, np.asarray(ebits))


@pytest.mark.parametrize("k,obj,wl", [(1, 1, 1), (7832, 128, 4), (100, 64, 32)])
def test_compact_leaf_bank_bytes_matches_reference(k, obj, wl):
    assert ops.compact_leaf_bank_bytes(k, obj, wl) == jops.compact_leaf_bank_bytes(k, obj, wl)


def test_unknown_fused_variant_rejected():
    case = fused_case(np.random.default_rng(1), 2, 2, 3, 4, 2)
    with pytest.raises(ValueError, match="variant"):
        ops.fused_gather_verify_compact(*fused_args(case), variant="tiled")


def test_cpu_tensors_never_launch_a_kernel():
    """On the CPU every wrapper runs its plain version, so no launch count
    moves; the plain versions are the reference oracles' twins."""
    _build.reset_launch_counts()
    rng = np.random.default_rng(2)
    case, _ = frontier_case(rng, 4, 9, 2)
    args = [to_torch(case[k]) for k in FRONTIER_ARGS]
    assert torch.equal(ops.filter_frontier_narrow(*args), ref.frontier_filter_narrow_ref(*args))
    fcase = fused_case(rng, 3, 2, 4, 8, 2)
    for variant in ("auto", "vmem", "prefetch"):
        got = ops.fused_gather_verify_compact(*fused_args(fcase), variant=variant)
        want = ref.fused_verify_compact_ref(*fused_args(fcase))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(_build.launch_counts().values())


def test_frontier_plain_matches_full_width_plain():
    """The port's narrow oracle equals its own f32 full-width oracle on the
    dequantized planes (the narrow encoding is lossless)."""
    rng = np.random.default_rng(11)
    case, (qb, f_mbrs, f_bm_full) = frontier_case(rng, 6, 20, 5)
    narrow = ref.frontier_filter_narrow_ref(*[to_torch(case[k]) for k in FRONTIER_ARGS])
    wide = ref.frontier_filter_ref(*map(to_torch, (case["q_rects"], qb, f_mbrs, f_bm_full, case["f_valid"])))
    assert torch.equal(narrow, wide)
