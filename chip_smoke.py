#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
then drives the port's main path -- single-device Boolean spatial-keyword
range (SKR) serving with the engine's default knobs -- on an index of the
``osm`` synthetic profile at 1,000,000 objects:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. builds the dataset, an STR R-tree (leaf 128, fanout 8) and the
   device snapshot, and serves the 4096-query MIX workload once in 4
   batches of 1024 to warm up, learn the frontier widths and capture each
   kernel's operands at the shapes the main path gives it;
3. one phase per kernel: holds the kernel against its plain PyTorch
   version on the card, bit-exact, at those shapes and at ragged edges, and
   times both (CUDA events);
4. the main path: serves the 4 batches through ``serve_batch`` (fused
   verify ``variant="auto"``, the (M, T) kernel), then through
   ``retrieve(fused_variant="vmem")`` (the query-tile kernel), with the
   launch counts zeroed before and read after each run; checks every output
   key against a run with the kernels swapped for their plain versions, and
   ids / ``nodes_checked`` / ``verified`` against the host oracle
   ``execute_serial`` on 256 queries with no overflow;
5. profiles one warm batch (``torch.profiler``: device busy and idle
   share, the largest device and host items);
6. prints the kernels' JSON line, then the result line.

Any failure raises and exits non-zero. Without a CUDA device, or outside
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

PROFILE = "osm"  # W = 256 words, vocabulary 8192: the largest profile
N_OBJECTS = 1_000_000
LEAF_SIZE = 128
FANOUT = 8
N_QUERIES = 4096
BATCH = 1024
MAX_LEAVES = 32
N_ORACLE = 256
SEED = 0
DEVICE = "cuda:0"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate


def log(*a) -> None:
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def patched(module, **attrs):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def max_abs_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def assert_same(got, want, what: str) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel disagrees with its plain version")


# ------------------------------------------------------------------ bounds
# Both bounds count what these operands need, each byte once: a dense plane
# the result depends on everywhere is read whole, a gathered or conditional
# one only where the data makes the result depend on it. A word scan that
# finds a hit needs one word (the hit proves it), one that finds none needs
# every word.
def needed_words(hit_words, live):
    """(..., W) mask of the words that decide ``any(hit_words)`` where
    ``live``: the first hit word where there is one, else all of them."""
    first = torch.nn.functional.one_hot(hit_words.int().argmax(-1), hit_words.shape[-1])
    return live[..., None] & torch.where(hit_words.any(-1, keepdim=True), first > 0, True)


def frontier_bound(args):
    """Valid flags in and survivor bytes out for every (query, slot); codes
    and their distinct dictionary entries only for valid slots; word-plane
    words only for valid slots whose rectangle meets the query."""
    q_rects, q_bits, f_codes, f_bm, f_valid, dict_x, dict_y = args
    M, F = f_valid.shape
    valid = f_valid > 0
    c = f_codes.long()
    cx = c[..., 0::2].clamp(0, dict_x.numel() - 1)
    cy = c[..., 1::2].clamp(0, dict_y.numel() - 1)
    x, y, q = dict_x[cx], dict_y[cy], q_rects[:, None, :]
    inter = (valid & (q[..., 0] <= x[..., 1]) & (x[..., 0] <= q[..., 2])
             & (q[..., 1] <= y[..., 1]) & (y[..., 0] <= q[..., 3]))
    need = needed_words((f_bm & q_bits[:, None, :]) != 0, inter)  # (M, F, Wp)
    n_valid = int(valid.sum())
    entries = torch.unique(cx[valid]).numel() + torch.unique(cy[valid]).numel()
    nbytes = (int(valid.any(1).sum()) * 16  # rects of queries with a valid slot
              + int(need.any(1).sum()) * 4  # query words some slot needs
              + M * F  # f_valid
              + n_valid * 8 + entries * 4  # codes, dictionary entries
              + int(need.sum()) * 4  # word-plane words
              + M * F)  # out
    ops = M * F + n_valid * 4 + int(need.sum()) * 2  # valid, rect compares, AND+test
    return nbytes, ops


def fused_bound(args):
    """Leaf ids and flags in, ids and counts out for every (query, slot);
    of the selected leaf rows (each bank element once): object ids of leaves
    some valid slot selects, signatures of live objects, compact words that
    decide a signature-passing object, coordinates of keyword hits."""
    q_rects, q_cbm, q_sig, top_leaf, leaf_ok, ox, oy, ocbm, osig, oid = args
    M, T = top_leaf.shape
    K, OBJ = ox.shape
    Wl = ocbm.shape[2]
    leaf = top_leaf.long().clamp(0, K - 1)
    ok = leaf_ok > 0
    obj = leaf[..., None] * OBJ + torch.arange(OBJ, device=leaf.device)  # (M, T, OBJ)
    live = (oid.reshape(-1)[obj] >= 0) & ok[..., None]
    sig = live & ((osig.reshape(-1)[obj] & q_sig[..., None]) != 0)
    hit = (ocbm.reshape(-1, Wl)[obj] & q_cbm[:, :, None, :]) != 0  # (M, T, OBJ, Wl)
    need = needed_words(hit, sig)
    kw = sig & hit.any(-1)
    word = obj[..., None] * Wl + torch.arange(Wl, device=leaf.device)
    distinct = lambda idx: torch.unique(idx).numel()  # noqa: E731
    nbytes = (int(kw.any(-1).any(-1).sum()) * 16  # rects of queries with a hit
              + int(need.any(2).sum()) * 4  # query words some object needs
              + int(live.any(-1).sum()) * 4  # q_sig of slots with a live object
              + M * T * (4 + 1)  # top_leaf, leaf_ok
              + distinct(leaf[ok]) * OBJ * 4  # obj_id of the selected rows
              + distinct(obj[live]) * 4  # obj_sig
              + distinct(word[need]) * 4  # obj_cbm
              + distinct(obj[kw]) * 8  # obj_x, obj_y
              + M * T * OBJ * 4 + M * T * 4)  # ids and kwv written once
    ops = (int(ok.sum()) * OBJ + int(live.sum()) * 2  # id test, sig AND+test
           + int(need.sum()) * 2 + int(kw.sum()) * 4)  # word AND+test, 4 compares
    return nbytes, ops


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_batch(serve_one, warm, plan_cache_cls) -> None:
    """Where one warm batch's time goes: ``torch.profiler`` over a single
    ``serve_batch`` call, device time by operation against the host clock."""
    from torch.profiler import ProfilerActivity, profile

    cache = plan_cache_cls()
    cache.widths = dict(warm.widths)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        serve_one(cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()
    # device-side events only (kernels and copies): the operator events that
    # launched them carry the same time again
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total / 1e3  # noqa: E731
    busy_ms = sum(dev(e) for e in on_device)
    log(f"profile of one batch (profiler on): wall {wall_ms:.6f} ms, device busy "
        f"{busy_ms:.6f} ms ({100 * busy_ms / wall_ms:.3f} %), "
        f"device idle {100 - 100 * busy_ms / wall_ms:.3f} %")
    for e in sorted(on_device, key=dev, reverse=True)[:8]:
        log(f"  device {dev(e):.6f} ms x{e.count}: {e.key[:100]}")
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        log(f"  host {e.self_cpu_time_total / 1e3:.6f} ms x{e.count}: {e.key[:100]}")


# --------------------------------------------------------- ragged operands
def ragged_frontier(dev, M=37, F=131, Wp=3, D=61, seed=5):
    g = np.random.default_rng(seed)
    dx = torch.from_numpy(np.sort(g.uniform(0, 1, D)).astype(np.float32)).to(dev)
    dy = torch.from_numpy(np.sort(g.uniform(0, 1, D)).astype(np.float32)).to(dev)
    lo = g.integers(0, D, (M, F, 2))
    hi = np.minimum(lo + g.integers(0, 8, (M, F, 2)), D - 1)
    codes = np.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]], -1).astype(np.int16)
    words = lambda *s: (g.integers(0, 2 ** 32, s, dtype=np.uint32)  # noqa: E731
                        * g.integers(0, 2, s, dtype=np.uint32)).view(np.int32)
    qlo = g.uniform(0, 0.8, (M, 2)).astype(np.float32)
    rects = np.concatenate([qlo, qlo + g.uniform(0.01, 0.3, (M, 2)).astype(np.float32)], 1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(rects), t(words(M, Wp)), t(codes), t(words(M, F, Wp)),
            t(g.integers(0, 2, (M, F)).astype(np.int8)), dx, dy)


def ragged_fused(dev, M=13, T=5, K=11, OBJ=37, Wl=2, seed=7):
    g = np.random.default_rng(seed)
    words = lambda *s: (g.integers(0, 2 ** 32, s, dtype=np.uint32)  # noqa: E731
                        * g.integers(0, 2, s, dtype=np.uint32)).view(np.int32)
    qlo = g.uniform(0, 0.8, (M, 2)).astype(np.float32)
    rects = np.concatenate([qlo, qlo + g.uniform(0.01, 0.3, (M, 2)).astype(np.float32)], 1)
    cbm = words(K, OBJ, Wl)
    sig = np.bitwise_or.reduce(cbm.view(np.uint32), axis=-1).view(np.int32)
    q_cbm = words(M, T, Wl)
    q_sig = np.bitwise_or.reduce(q_cbm.view(np.uint32), axis=-1).view(np.int32)
    oid = np.where(g.integers(0, 4, (K, OBJ)) > 0, g.integers(0, 10_000, (K, OBJ)), -1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(rects), t(q_cbm), t(q_sig), t(g.integers(-2, K + 3, (M, T)).astype(np.int32)),
            t(g.integers(0, 2, (M, T)).astype(np.int8)),
            t(g.uniform(0, 1, (K, OBJ)).astype(np.float32)),
            t(g.uniform(0, 1, (K, OBJ)).astype(np.float32)),
            t(cbm), t(sig), t(oid.astype(np.int32)))


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.baselines.conventional import build_str_rtree
    from repro_torch.core.query import execute_serial
    from repro_torch.data.synth import make_dataset
    from repro_torch.data.workloads import make_workload
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch.wisk_serve import serve_batch
    from repro_torch.serve.engine import retrieve
    from repro_torch.serve.plan import PlanCache
    from repro_torch.serve.snapshot import IndexSnapshot

    dev = torch.device(DEVICE)
    card = gpu_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s")
    for src, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # ---------------------------------------------------- data and index
    t0 = time.perf_counter()
    ds = make_dataset(PROFILE, n=N_OBJECTS, seed=SEED)
    t1 = time.perf_counter()
    index = build_str_rtree(ds, leaf_size=LEAF_SIZE, fanout=FANOUT)
    t2 = time.perf_counter()
    snap = IndexSnapshot.build(index, ds, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    assert snap.has_narrow_planes, "a level overflowed NARROW_DICT_MAX"
    assert snap.has_compact_bank, "a leaf overflowed LEAF_DICT_MAX"
    log(f"dataset {PROFILE} n={ds.n} W={ds.words} vocab={ds.vocab_size}: {t1 - t0:.3f} s")
    log(f"str-rtree levels={[l.n for l in index.levels]}: {t2 - t1:.3f} s")
    log(f"snapshot: {t3 - t2:.3f} s, {snap.nbytes()} B on the device, "
        f"OBJ={snap.obj_per_leaf} Wl={snap.n_compact_words} "
        f"dicts={[int(d.numel()) for d in snap.level_dict_x]}")
    wl = make_workload(ds, m=N_QUERIES, dist="MIX", seed=1)
    batches = [np.arange(i, i + BATCH) for i in range(0, N_QUERIES, BATCH)]

    # ------------------------------- warm-up pass, capturing kernel operands
    captured = {}

    def recorder(key, fn, size_arg):
        """Pass calls through to ``fn``, keeping the largest call's operands."""
        def rec(*args, **kw):
            prev = captured.get(key)
            if prev is None or args[size_arg].numel() > prev[size_arg].numel():
                captured[key] = args
            return fn(*args, **kw)
        return rec

    warm = PlanCache()
    t0 = time.perf_counter()
    with patched(ops,  # sized by f_valid (M, F) and top_leaf (M, T)
                 filter_frontier_narrow=recorder("frontier", ops.filter_frontier_narrow, 4),
                 fused_gather_verify_compact=recorder(
                     "fused", ops.fused_gather_verify_compact, 3)):
        for b in batches:
            serve_batch(snap, wl.rects[b], wl.kw_bitmap[b], MAX_LEAVES, plan_cache=warm)
    log(f"warm-up pass (learns widths {sorted(warm.widths.items())}): "
        f"{time.perf_counter() - t0:.3f} s")

    # ------------------------------------------------------- kernel phases
    rows = []
    f_args, fu_args = captured["frontier"], captured["fused"]
    plain_fused = lambda *a: ref.fused_verify_compact_ref(*a)  # noqa: E731
    phases = [
        ("frontier_narrow", "cuda", "src/repro_torch/kernels/csrc/frontier_narrow.cu",
         "src/repro/kernels/frontier.py:113", f_args,
         [ragged_frontier(dev), ragged_frontier(dev, M=1, F=1, Wp=1, D=2, seed=9)],
         ops.filter_frontier_narrow, ref.frontier_filter_narrow_ref, frontier_bound),
        ("fused_verify_compact_tile", "cuda", "src/repro_torch/kernels/csrc/fused_verify_compact.cu",
         "src/repro/kernels/fused_verify.py:267", fu_args,
         [ragged_fused(dev), ragged_fused(dev, M=1, T=1, K=1, OBJ=1, Wl=1, seed=3)],
         lambda *a: ops.fused_gather_verify_compact(*a, variant="vmem"), plain_fused, fused_bound),
        ("fused_verify_compact_slot", "cuda", "src/repro_torch/kernels/csrc/fused_verify_compact.cu",
         "src/repro/kernels/fused_verify.py:345", fu_args,
         [ragged_fused(dev), ragged_fused(dev, M=1, T=1, K=1, OBJ=1, Wl=1, seed=3)],
         lambda *a: ops.fused_gather_verify_compact(*a, variant="prefetch"), plain_fused,
         fused_bound),
    ]
    for name, route, source, replaces, args, ragged, kernel, plain, bound in phases:
        for case in [args, *ragged]:
            got = kernel(*case)
            torch.cuda.synchronize()
            assert_same(got, plain(*case), f"{name} at {[tuple(a.shape) for a in case[:5]]}")
        err = max_abs_err(kernel(*args), plain(*args))
        torch.cuda.synchronize()
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args), iters=10)
        nbytes, nops = bound(args)
        b_ms, b_by = bound_ms(nbytes, nops)
        shapes = [tuple(a.shape) for a in args]
        log(f"phase {name}: bit-exact vs plain at main-path shapes {shapes} and "
            f"{len(ragged)} ragged cases; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}: {nbytes} B, {nops} ops)")
        rows.append(dict(name=name, route=route, source=source, replaces=replaces,
                         launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # ----------------------------------------------------------- main path
    def serve_all(variant=None):
        cache = PlanCache()
        cache.widths = dict(warm.widths)
        outs, times = [], []
        for b in batches:
            t = time.perf_counter()
            if variant is None:
                out = serve_batch(snap, wl.rects[b], wl.kw_bitmap[b], MAX_LEAVES, plan_cache=cache)
            else:
                out = retrieve(snap, wl.rects[b], wl.kw_bitmap[b], MAX_LEAVES,
                               plan_cache=cache, fused_variant=variant)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            outs.append(out)
        return outs, times

    _build.reset_launch_counts()
    main_out, main_t = serve_all()
    main_counts = _build.launch_counts()
    log(f"main path serve_batch x{len(batches)} (auto): batch s {main_t}, launches {main_counts}")
    _build.reset_launch_counts()
    vmem_out, vmem_t = serve_all("vmem")
    vmem_counts = _build.launch_counts()
    log(f"main path retrieve(fused_variant='vmem') x{len(batches)}: batch s {vmem_t}, "
        f"launches {vmem_counts}")
    for key, counts in (("frontier_narrow", main_counts),
                        ("fused_verify_compact_slot", main_counts),
                        ("fused_verify_compact_tile", vmem_counts)):
        if counts[key] <= 0:
            raise AssertionError(f"the main path never launched {key}")
    launches = {"frontier_narrow": main_counts["frontier_narrow"],
                "fused_verify_compact_slot": main_counts["fused_verify_compact_slot"],
                "fused_verify_compact_tile": vmem_counts["fused_verify_compact_tile"]}
    for r in rows:
        r["launches"] = launches[r["name"]]

    _build.reset_launch_counts()
    with patched(ops, filter_frontier_narrow=ref.frontier_filter_narrow_ref,
                 fused_gather_verify_compact=lambda *a, variant="auto": plain_fused(*a)):
        plain_out, plain_t = serve_all()
    if any(_build.launch_counts().values()):
        raise AssertionError("the plain run launched a kernel")
    log(f"plain-version run: batch s {plain_t}")
    for run, outs in (("auto", main_out), ("vmem", vmem_out)):
        for bi, (got, want) in enumerate(zip(outs, plain_out)):
            if set(got) != set(want):
                raise AssertionError(f"{run} batch {bi}: keys differ")
            for k in want:
                g, w = np.asarray(got[k]), np.asarray(want[k])
                if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(g, w):
                    raise AssertionError(f"{run} batch {bi}: {k} differs from the plain run")
    log("main path equals the plain-version run on every key, dtype and shape")

    # ---------------------------------------------------------- host oracle
    cat = {k: np.concatenate([o[k] for o in main_out]) for k in
           ("ids", "nodes_checked", "verified", "overflow", "counts")}
    ok = np.flatnonzero(cat["overflow"] == 0)[:N_ORACLE]
    if ok.size < N_ORACLE:
        raise AssertionError(f"only {ok.size} queries without overflow")
    t0 = time.perf_counter()
    st = execute_serial(index, ds, wl.subset(ok))
    for j, q in enumerate(ok):
        row = cat["ids"][q]
        if not np.array_equal(np.sort(row[row >= 0]), np.sort(st.results[j])):
            raise AssertionError(f"query {q}: ids differ from execute_serial")
    if not np.array_equal(cat["nodes_checked"][ok], st.nodes_accessed):
        raise AssertionError("nodes_checked differs from execute_serial")
    if not np.array_equal(cat["verified"][ok], st.verified):
        raise AssertionError("verified differs from execute_serial")
    log(f"execute_serial oracle on {ok.size} queries with overflow == 0: equal "
        f"({time.perf_counter() - t0:.3f} s); queries with overflow: "
        f"{int((cat['overflow'] > 0).sum())} of {N_QUERIES}, results {int(cat['counts'].sum())}")

    profile_batch(lambda cache: serve_batch(snap, wl.rects[batches[0]], wl.kw_bitmap[batches[0]],
                                            MAX_LEAVES, plan_cache=cache), warm, PlanCache)

    log(f"card: {card}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
