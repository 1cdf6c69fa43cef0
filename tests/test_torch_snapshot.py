"""The port's data, index and snapshot layers against the JAX package, and
the port's isolation from it.

* The port's numpy copies (``make_dataset``, ``make_workload``,
  ``build_str_rtree``, ``build_grid_index``) give the reference's bits for
  the same seed.
* ``IndexSnapshot.build`` equals the JAX snapshot field for field
  (``obj_per_leaf`` and ``Wl`` included), bitmaps compared as u32 views;
  ``from_reference_arrays`` carries a JAX snapshot across unchanged.
* ``repro_torch`` imports no JAX and nothing of ``repro``, and its entry
  points refuse to drift onto the CPU.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.baselines import conventional as jconv  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core.packing import HierarchyResult as JHierarchy  # noqa: E402
from repro.core.types import ClusterSet as JClusterSet  # noqa: E402
from repro.data import synth as jsynth, workloads as jworkloads  # noqa: E402
from repro.serve import snapshot as jsnapshot  # noqa: E402
from repro_torch.baselines import conventional  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core.types import ClusterSet  # noqa: E402
from repro_torch.data import synth, workloads  # noqa: E402
from repro_torch.serve import snapshot  # noqa: E402
from repro_torch.serve.snapshot import IndexSnapshot  # noqa: E402

from test_torch_cases import clustered_bank, to_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_index(ti, ji):
    assert ti.height == ji.height
    for tl, jl in zip(ti.levels, ji.levels):
        for f in ("mbrs", "bitmaps", "child_ptr", "child"):
            _same(getattr(tl, f), getattr(jl, f), f)
    for f in ("assign", "order", "offsets", "mbrs", "bitmaps"):
        _same(getattr(ti.clusters, f), getattr(ji.clusters, f), f)
    for f in ("kw_ptr", "kw", "obj_ptr", "obj"):
        _same(getattr(ti.inv, f), getattr(ji.inv, f), f)
    assert ti.meta == ji.meta


def _same_snapshot(ts, js):
    """Field for field, bitmaps as their u32 views; the reference's dense
    child matrices are the one field the port does not build."""
    assert ts.obj_per_leaf == js.obj_per_leaf
    assert ts.has_narrow_planes == js.has_narrow_planes
    assert ts.has_compact_bank == js.has_compact_bank
    for name in snapshot.ARRAY_FIELDS:
        got, want = getattr(ts, name), getattr(js, name)
        if isinstance(want, list):
            assert isinstance(got, list) and len(got) == len(want), name
            pairs = zip(got, want)
        elif want is None:
            assert got is None, name
            continue
        else:
            pairs = [(got, want)]
        for g, w in pairs:
            _same(to_numpy(g, w), w, name)
    if js.has_compact_bank:
        assert ts.n_compact_words == js.n_compact_words


# ------------------------------------------------------- data and layouts
@pytest.mark.parametrize("profile,n,seed", [("fs", 1500, 0), ("sp", 800, 3), ("bpd", 700, 1), ("osm", 2000, 7)])
def test_make_dataset_matches_reference(profile, n, seed):
    got, want = synth.make_dataset(profile, n=n, seed=seed), jsynth.make_dataset(profile, n=n, seed=seed)
    for f in ("locs", "kw_ids", "kw_bitmap", "kw_freq"):
        _same(getattr(got, f), getattr(want, f), f)
    assert got.vocab_size == want.vocab_size


@pytest.mark.parametrize("dist", ["UNI", "LAP", "GAU", "MIX"])
def test_make_workload_matches_reference(dist):
    ds, jds = synth.make_dataset("osm", n=1200, seed=2), jsynth.make_dataset("osm", n=1200, seed=2)
    got = workloads.make_workload(ds, m=40, dist=dist, seed=5)
    want = jworkloads.make_workload(jds, m=40, dist=dist, seed=5)
    for f in ("rects", "kw_ids", "kw_bitmap"):
        _same(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("leaf_size,fanout", [(128, 8), (16, 4), (2000, 8)])
def test_build_str_rtree_matches_reference(leaf_size, fanout):
    ds, jds = synth.make_dataset("sp", n=1800, seed=1), jsynth.make_dataset("sp", n=1800, seed=1)
    _same_index(conventional.build_str_rtree(ds, leaf_size, fanout),
                jconv.build_str_rtree(jds, leaf_size, fanout))


def test_build_grid_index_matches_reference():
    ds, jds = synth.make_dataset("fs", n=1000, seed=4), jsynth.make_dataset("fs", n=1000, seed=4)
    _same_index(conventional.build_grid_index(ds, 5), jconv.build_grid_index(jds, 5))


def test_assemble_index_matches_reference():
    """A hand-made two-level hierarchy over grid clusters assembles alike."""
    ds, jds = synth.make_dataset("fs", n=900, seed=6), jsynth.make_dataset("fs", n=900, seed=6)
    cell = np.minimum((ds.locs * 4).astype(np.int32), 3)
    assign = np.unique(cell[:, 0] * 4 + cell[:, 1], return_inverse=True)[1].astype(np.int32)
    tc, jc = ClusterSet.from_assignment(ds, assign), JClusterSet.from_assignment(jds, assign)
    parent = (np.arange(tc.k) // 3).astype(np.int32)
    _same_index(tindex.assemble_index(ds, tc, tindex.HierarchyResult(parents=[parent])),
                jindex.assemble_index(jds, jc, JHierarchy(parents=[parent], level_labels=[], packs=[])))


# --------------------------------------------------------------- snapshot
@pytest.fixture(scope="module")
def layouts():
    ds, jds = synth.make_dataset("sp", n=2500, seed=8), jsynth.make_dataset("sp", n=2500, seed=8)
    return ds, jds, {
        "grid": (conventional.build_grid_index(ds, 6), jconv.build_grid_index(jds, 6)),
        "str": (conventional.build_str_rtree(ds, 32, 4), jconv.build_str_rtree(jds, 32, 4)),
        "str-deep": (conventional.build_str_rtree(ds, 8, 3), jconv.build_str_rtree(jds, 8, 3)),
    }


@pytest.mark.parametrize("layout", ["grid", "str", "str-deep"])
def test_snapshot_build_matches_reference(layouts, layout):
    ds, jds, built = layouts
    ti, ji = built[layout]
    ts = IndexSnapshot.build(ti, ds, device="cpu")
    js = jsnapshot.IndexSnapshot.build(ji, jds)
    assert ts.device.type == "cpu"
    assert ts.has_narrow_planes and ts.has_compact_bank
    _same_snapshot(ts, js)


@pytest.mark.parametrize("layout", ["grid", "str"])
def test_from_reference_arrays_round_trips(layouts, layout):
    """The JAX snapshot's arrays carried across equal it field for field,
    and equal the port's own build of the same index."""
    ds, jds, built = layouts
    js = jsnapshot.IndexSnapshot.build(built[layout][1], jds)
    fields = {}
    for name in jsnapshot._ARRAY_FIELDS:
        v = getattr(js, name)
        fields[name] = [np.asarray(a) for a in v] if isinstance(v, list) else (
            None if v is None else np.asarray(v))
    ts = IndexSnapshot.from_reference_arrays(fields, js.obj_per_leaf, device="cpu")
    _same_snapshot(ts, js)
    own = IndexSnapshot.build(built[layout][0], ds, device="cpu")
    assert own.nbytes() == ts.nbytes()


def test_encode_leaf_vocab_matches_reference():
    rng = np.random.default_rng(9)
    bank = clustered_bank(rng, 12, 16, 6, pool_size=40, max_kw=8)
    bank[3] = 0  # an empty leaf: no dictionary, no bits
    for got, want in zip(snapshot.encode_leaf_vocab(bank), jsnapshot.encode_leaf_vocab(bank)):
        _same(got, want)


def test_dictionary_overflow_disables_the_narrow_planes_and_compact_bank():
    """Past the int16 code space / the leaf dictionary cap the encoders
    return their disable sentinels, exactly like the reference's."""
    n = snapshot.NARROW_DICT_MAX + 1
    xs = np.arange(n, dtype=np.float32) / n
    mbrs = np.stack([xs, xs, xs, xs], axis=1)
    assert snapshot.encode_mbr_planes([mbrs]) == ([], [], [])
    assert jsnapshot.encode_mbr_planes([mbrs]) == ([], [], [])
    bank = clustered_bank(np.random.default_rng(4), 2, 4, 2, pool_size=40)
    assert snapshot.encode_leaf_vocab(bank, cap=3) == (None, None, None)
    assert jsnapshot.encode_leaf_vocab(bank, cap=3) == (None, None, None)
    assert (snapshot.NARROW_DICT_MAX, snapshot.LEAF_DICT_MAX) == (
        jsnapshot.NARROW_DICT_MAX, jsnapshot.LEAF_DICT_MAX)


def test_entry_points_run_on_cuda_unless_told_otherwise(layouts):
    """With no ``device`` the snapshot goes to the card; without a card
    that raises instead of quietly serving on the CPU."""
    ds, jds, built = layouts
    js = jsnapshot.IndexSnapshot.build(built["grid"][1], jds)
    fields = {n: (np.asarray(getattr(js, n)) if not isinstance(getattr(js, n), list)
                  else [np.asarray(a) for a in getattr(js, n)]) for n in snapshot.ARRAY_FIELDS}
    if torch.cuda.is_available():
        assert IndexSnapshot.build(built["grid"][0], ds).device.type == "cuda"
        assert IndexSnapshot.from_reference_arrays(fields, js.obj_per_leaf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            IndexSnapshot.build(built["grid"][0], ds)
        with pytest.raises(RuntimeError, match="CUDA"):
            IndexSnapshot.from_reference_arrays(fields, js.obj_per_leaf)


def test_snapshot_is_frozen(layouts):
    ds, _, built = layouts
    ts = IndexSnapshot.build(built["grid"][0], ds, device="cpu")
    with pytest.raises(dataclasses.FrozenInstanceError):
        ts.obj_per_leaf = 1


# -------------------------------------------------------------- isolation
_PROBE = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference_module():
    """Every module of the port imports with JAX and the ``repro`` package
    made unimportable, and none of them ends up in ``sys.modules``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_scan_finds_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 16
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"
