#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
then drives the port's serving paths on an index of the ``osm`` synthetic
profile at 1,000,000 objects (STR R-tree, leaf 128, fanout 8) with the
4096-query MIX workload in 4 batches of 1024:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. builds the dataset, the index and the device snapshot; serves the SKR
   batches and the kNN batches (k = 10, query points at the centres of the
   MIX rectangles) once each to warm up, learn the frontier widths and
   capture each kernel's operands at the shapes the path gives it;
3. SKR main path: serves the batches through ``serve_batch`` (fused verify
   ``variant="auto"``) and ``retrieve(fused_variant="vmem")``, with the
   launch counts zeroed before and read after each run (the descent on
   ``frontier_level_narrow``, once per level, with the gathered-plane
   frontier wrappers refused, as on every descent; the compact fused
   verify's remapping instance once a batch, ``fused_verify_remap_slot`` or
   in the ``vmem`` run ``fused_verify_remap_tile``, with
   ``remap_query_words`` refused, as in every fused SKR run below); checks
   every output
   key against a run with the kernels swapped for their plain versions, and
   ids / ``nodes_checked`` / ``verified`` against the host oracle
   ``execute_serial`` on 256 queries with no overflow;
4. kNN main path: serves the batches through ``serve_knn_batch`` at k = 10
   (counts zeroed before, read after; the narrow descent on
   ``knn_level_dist_narrow``, with the gathered-plane wrappers refused),
   checks every key against its
   plain-version rerun, ids and ``dist2`` bit for bit against the host
   oracle ``knn_query`` on 256 queries, and the pruning ratio (m * n_leaf /
   leaves verified) above 1; then one batch each at k = 1 and k = 100
   against the oracle, and one batch with ``knn_dtype="bf16"`` against f32;
5. the f32 descent: the SKR batches and one kNN batch with
   ``quantized=False`` (counts zeroed before, read after; the SKR batches
   on ``frontier_level`` once per level, the kNN batch on
   ``knn_level_dist`` alone, its peak device memory below one (M, F, W)
   word plane), then one SKR and one kNN batch on the snapshot with its
   narrow planes stripped (what an overflowing coordinate dictionary
   gives), all equal to the default runs;
6. the verify knobs: one SKR batch each with ``fused=False``,
   ``compact=False`` (the (M, T) and the query-tile launch),
   ``fused=False, compact=False`` and on the snapshot with its compact bank
   stripped (what a leaf dictionary above ``LEAF_DICT_MAX`` gives), each
   equal to the default run and each launching its verify kernel;
7. live updates: two ``DeltaLog``s over the snapshot, each taking 10,000
   inserts (1 % of n, in batches of 1,000) and 5,000 deletes (100 of them
   buffered inserts). Log A's inserts carry terms of the leaf they route
   to, so its insert slots stay on the compact words (``compact_ok``);
   log B's are jittered copies of random objects with their own keywords,
   which flips ``compact_ok``. Per log: the host time per insert batch,
   ``slots_per_leaf``, the delta's bytes on the device; a buffer taken
   before the last insert still gives its earlier answer; the SKR batches
   through ``serve_batch(delta=...)`` and one kNN batch at k = 10 through
   ``serve_knn_batch(delta=...)`` (warm, counts zeroed before, read after;
   the SKR descent on ``frontier_level`` once per level, the insert slots
   through the slot entry that reads the delta's buffers, log A's
   ``skr_verify_slots_compact`` -- on the words the fused verify remapped --
   and log B's ``skr_verify_slots``, once a batch, and no gathered verify
   entry) equal their plain-version reruns on
   every key, SKR ids equal ``execute_serial`` and kNN ids and ``dist2``
   equal ``knn_query`` on 256 queries each, over a cold STR index of
   ``merged_dataset()``; then log B's warm delta SKR batch holds its peak
   device memory above its start below one (M, T*B, W) int32 plane of its
   insert slots;
8. the dense A/B scan: the snapshot is built with ``dense=True`` (its
   child matrices); the SKR batches through ``serve_batch(mode="dense")``
   (counts zeroed before, read after; ``skr_filter`` once per level) and
   one batch with log A's delta, each equal on every key to its
   plain-version rerun, with the frontier run's ``overflow`` and result
   sets, ``nodes_scanned`` at or above the frontier's, and ids equal to
   ``execute_serial`` on the 256 oracle queries; each of the first batch's
   five ``skr_filter`` launches timed alone, and their sum;
9. standing subscriptions: 100,000 subscriptions with the rectangles and
   keywords of a MIX workload (seed 2) in a ``SubscriptionIndex`` on the
   card; log A's 10,000 inserts arrive in batches of 1,000 through a
   ``DeltaLog`` and ``match_arrivals`` in the same step; after the fifth
   batch 10,000 subscriptions leave and 10,000 new ones take their slots
   (counts zeroed before, read after: the pairs instance
   ``sub_match_pairs`` for every match, the matrix instance never, with
   the matrix entries and ``pack_query_words`` refused; per batch the
   notifications, the retries, the host time by step -- bitmaps, upload,
   block compile, kernel and count readback, sort and copy, the rest --
   and the peak device memory, below one (N, S) int8 matrix); ``pump``
   afterwards queues nothing, a twin index driven by ``pump`` alone
   drains the identical stream, a rerun with the pairs entry swapped for
   its plain version gives the same stream pair for pair, and on a seeded
   sample of 256 subscriptions the stream equals ``SubscriptionOracle``'s
   replay; then the matrix entry ``match_subscriptions`` once on the
   first arrival batch, its nonzero entries equal to the pairs;
10. the CDF-MLP bank: ``cdf_bank_forward`` of a seeded bank of
   1->16->16->16->1 MLPs, two per ``osm`` keyword held by at least 0.1 % of
   the objects, at every object's x coordinate, against the chunked plain
   version to ``atol=2e-6``; then banks of B off the kernel's 8-model tile
   at H = 32 and H = 4 on objects' x with NaN, infinite and far points
   written in (``CDF_EDGE_X``), NaN exactly where the points are NaN;
11. one phase per kernel (13, and row 11's two instances): holds the
   kernel against its plain PyTorch version on the card -- bit-exact, the
   CDF bank to ``atol=2e-6``, the match pairs in canonical order, a NaN
   equal to a NaN -- at the captured shapes (rows 2 and 3: the remapping
   instances, also with ``words=True``; rows 9 and 10: the slot entries at
   logs A's and B's insert slots; row 12 at all five levels) and at ragged
   edges (rows 7 and 8 also at NaN and infinite query points, row 13 at
   every hidden width, B of 1 to 196 and edge points), and
   times the kernel's launches on the device (``torch.profiler``; it
   fails where the profiler saw too few launches; the wrapper's time a
   call back to back, CUDA events, in the log beside it) and the plain version
   (CUDA events) beside a bound; the match pairs at capacity 0
   and 1 (one retry each); then times the (M, F, W) gather the f32 kNN
   descent no longer makes, and holds ``knn_frontier_dist(_narrow)`` and
   ``filter_frontier(_narrow)`` (gathered operands, through the level
   kernels), the given-words instances of rows 2 and 3 (timed), the
   query-tile verify without packed words and the unfused verify's
   gathered entries (ids and both counts; at the knob shapes, timed)
   against their plain versions; then times, at the captured shapes, the
   per-slot planes the engine no longer gathers for rows 1, 4, 7, 9 and 10,
   the keyword recounts of rows 9 and 10, the host packing the SKR batch no
   longer makes, ``remap_query_words``, the per-slot query words rows 2
   and 3 no longer take, and the subscription stream's host packing and
   ``torch.nonzero`` over the (N, S) match matrix;
12. profiles one warm SKR batch, one warm kNN batch, one warm dense-scan
   batch and one warm SKR batch each with log B's and log A's deltas
   (``torch.profiler``: device busy and idle share, the largest device and
   host items);
13. construction: ``build_wisk`` on the card over the same 1,000,000
   objects with ``BuildConfig()`` (itemsets, the CDF bank, learned splits,
   DQN packing), trained on a MIX workload of 4096 queries (seed 3; the
   served workload is seed 1): each phase's seconds, the counters, K and
   the level widths, the bank's B, E and final loss, each packed level's
   ``n_upper`` and the peak device memory; the learned index's snapshot
   (bytes, OBJ, compact bank, narrow planes) serves the 4 batches, the
   first batch's queries without overflow equal ``execute_serial``, and
   its mean per-query Eq. 1 cost is printed beside the STR R-tree's (not a
   claim); then twin builds at 120,000 objects, equal bit for bit
   (partition, hierarchy, bank), an ``accelerated=True`` build, and a
   ``warm_start_rebuild`` of the first twin for a GAU workload (regressed
   leaves detected) whose index serves a batch equal to ``execute_serial``;
14. prints the kernels' JSON line, then the result line.

Every phase prints its seconds. Any failure raises and exits non-zero.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
K = 10  # neighbours per kNN query on the main path
N_INSERT = 10_000  # per delta log: 1 % of N_OBJECTS
INSERT_BATCH = 1_000
N_DELETE = 5_000  # per delta log, of which
N_DELETE_BUFFERED = 100  # are buffered inserts
K_EDGES = (1, 100)  # one batch each, checked against the host oracle
N_SUBS = 100_000  # standing subscriptions
N_SUB_CHURN = 10_000  # leave after the fifth arrival batch, then as many join
N_SUB_SAMPLE = 256  # subscriptions held against the host oracle
CDF_HIDDEN = 16
CDF_HIGH_FRAC = 0.001  # keywords at or above this share of objects get an MLP (x and y)
N_TRAIN = 4096  # construction: training queries (MIX, seed 3; the served workload is seed 1)
N_TWIN = 120_000  # construction: the twin builds at the osm profile's own size
CDF_ATOL = 2e-6
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


@contextlib.contextmanager
def phase(name: str):
    t = time.perf_counter()
    yield
    log(f"[phase {name}: {time.perf_counter() - t:.3f} s]")


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


# the port's CUDA kernels, as torch.profiler names their device events
KERNEL_FUNCTIONS = ("cdf_mlp_kernel", "frontier_level_kernel", "fused_verify_slot_kernel",
                    "fused_verify_tile_kernel", "fused_verify_wide_slot_kernel",
                    "fused_verify_wide_tile_kernel", "knn_level_kernel", "skr_filter_kernel",
                    "slot_verify_kernel", "sub_match_kernel")


def device_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 10):
    """``(ms, launches)``: the mean device time of one launch of the port's
    CUDA kernels (``KERNEL_FUNCTIONS``; no copy, fill or PyTorch kernel)
    that ``fn`` makes, and their launches the profiler saw per call, from
    ``torch.profiler``. Unlike ``time_ms`` it does not count the host's time
    between launches, which bounds back-to-back calls of a kernel shorter
    than its wrapper. The profiler drops some kernel events of a short
    window (in one run of the H100 smoke, 61 % of them over five windows),
    so the mean is per launch seen, over up to ``tries`` windows until half
    the calls' launches were seen; it raises if they never were. ``tools/serve_ab.py`` times its kernels with it too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    total_us = seen = 0
    for t in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and any(f"{k}(" in e.key or f"{k}<" in e.key for k in KERNEL_FUNCTIONS)]
        total_us += sum(e.self_device_time_total for e in ours)
        seen += sum(e.count for e in ours)
        if seen >= t * iters // 2:
            return total_us / 1e3 / seen, seen / (t * iters)
    raise RuntimeError(f"the profiler saw {seen} kernel launches in {tries * iters} calls")


def kernel_ms(fn):
    """``(ms, note)``: ``fn``'s kernel time a launch on the device
    (``device_ms``), and a note with it and the wrapper's time a call back
    to back."""
    call = time_ms(fn)
    dev, seen = device_ms(fn)
    return dev, (f"{dev:.6f} ms on the device a launch ({seen:g} launches seen a call), wrapper "
                 f"{call:.6f} ms per call back to back")


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
    """Largest difference; equal infinities and two NaNs differ by 0, a NaN
    against a number by NaN."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if not a.numel():
        return 0.0
    diff = (a.double() - b.double()).abs()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(torch.where(same, 0.0, diff).max())


def assert_same(got, want, what: str, atol: float = 0.0) -> None:
    """Kernel output equal to the plain version's: bit for bit, or within
    ``atol`` where one is given; a NaN equals a NaN."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: kernel disagrees with its plain version")
        if g.is_floating_point():
            same = bool(torch.allclose(g, w, atol=atol, rtol=0, equal_nan=True))
        else:
            same = torch.equal(g, w)
        if not same:
            raise AssertionError(f"{what}: kernel disagrees with its plain version")


def shapes(case):
    """The shapes of a kernel's operands (a dict of weights counts as one, a
    tuple of tensors as a list of shapes, a flag as itself)."""
    return [{k: tuple(v.shape) for k, v in a.items()} if isinstance(a, dict)
            else shapes(a) if isinstance(a, tuple)
            else tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in case]


# ------------------------------------------------------------------ bounds
# Both bounds count what these operands need, each byte once: a dense plane
# the result depends on everywhere is read whole, a gathered or conditional
# one only where the data makes the result depend on it. A word scan that
# finds a hit needs one word (the hit proves it); one that finds none needs
# the words where the query's word is nonzero, since no other word can hit.
def needed_words(hit_words, live, q_nonzero):
    """(..., W) mask of the words that decide ``any(hit_words)`` where
    ``live``: the first hit word where there is one, else the words where
    ``q_nonzero`` (a mask broadcast to ``hit_words``: the query's word is
    nonzero) holds."""
    W = hit_words.shape[-1]
    first = hit_words.to(torch.uint8).argmax(-1, keepdim=True)
    first = torch.arange(W, device=hit_words.device) == first
    return live[..., None] & torch.where(hit_words.any(-1, keepdim=True), first, q_nonzero)


def slot_bound(args, narrow: bool, chunk: int = 32):
    """Bytes and operations of ``frontier_level`` (or, ``narrow``,
    ``frontier_level_narrow``): every frontier id in and every flag out; of
    a valid slot, its node's MBR -- 16 bytes, or 8 bytes of codes and the
    distinct dictionary entries they read -- each node once, however many
    queries need it; of a slot whose MBR also meets the query's rectangle,
    the node words that decide its keyword test (each node word once); the
    rectangles of queries with a valid slot; and the W words of each query
    with a slot that meets, which the kernel reads whole to find its nonzero
    words. Counted ``chunk`` queries at a time, so the (M, F, W) hit plane
    never exists whole."""
    if narrow:
        q_rects, q_bm, codes, bms, frontier, dict_x, dict_y = args
        c = codes.long()
        cx = c[:, 0::2].clamp(0, dict_x.numel() - 1)
        cy = c[:, 1::2].clamp(0, dict_y.numel() - 1)
        x, y = dict_x[cx], dict_y[cy]  # (N, 2): lo, hi
    else:
        q_rects, q_bm, mbrs, bms, frontier = args
        x, y = mbrs[:, 0::2], mbrs[:, 1::2]
    M, F = frontier.shape
    N, W = bms.shape
    valid = frontier >= 0
    node = frontier.long().clamp(0, N - 1)
    qr = q_rects[:, None, :]
    nx, ny = x[node], y[node]  # (M, F, 2)
    meet = (valid & (qr[..., 0] <= nx[..., 1]) & (nx[..., 0] <= qr[..., 2])
            & (qr[..., 1] <= ny[..., 1]) & (ny[..., 0] <= qr[..., 3]))
    node_words = torch.zeros(N * W, dtype=torch.bool, device=bms.device)
    n_need = 0
    cols = torch.arange(W, device=bms.device)
    for m0 in range(0, M, chunk):
        sl = slice(m0, m0 + chunk)
        qb = q_bm[sl, None, :]
        need = needed_words((bms[node[sl]] & qb) != 0, meet[sl], qb != 0)  # (c, F, W)
        node_words[(node[sl, :, None] * W + cols)[need]] = True
        n_need += int(need.sum())
    mbr_nodes = torch.unique(node[valid])
    if narrow:
        mbr_bytes = (mbr_nodes.numel() * 8 + torch.unique(cx[mbr_nodes]).numel() * 4
                     + torch.unique(cy[mbr_nodes]).numel() * 4)
    else:
        mbr_bytes = mbr_nodes.numel() * 16
    nbytes = (M * F * 4  # frontier
              + int(valid.any(1).sum()) * 16  # rectangles of queries with a valid slot
              + mbr_bytes  # MBRs (codes and dictionary entries) of valid slots' nodes
              + int(meet.any(1).sum()) * W * 4  # query words, read whole to compact them
              + int(node_words.sum()) * 4  # node words
              + M * F)  # out
    ops = M * F + int(valid.sum()) * 4 + n_need * 2  # id test, 4 compares, AND+test
    return nbytes, ops


def level_bound(args, narrow: bool = False):
    """Bytes and operations of ``knn_level_dist`` (or, ``narrow``,
    ``knn_level_dist_narrow``): every frontier id in and every distance
    out; of a valid slot, the node words at the query's packed words that
    decide its keyword test (each node word once, however many queries need
    it), and the node's MBR where it hits -- 16 bytes, or 8 bytes of codes
    and the distinct dictionary entries they read; query points and (id,
    value) word pairs where some slot needs them."""
    if narrow:
        q_pts, wids, bits, codes, bms, frontier, dict_x, dict_y = args
    else:
        q_pts, wids, bits, mbrs, bms, frontier = args
    M, F = frontier.shape
    N, W = bms.shape
    valid = frontier >= 0
    node = frontier.long().clamp(0, N - 1)
    word = node[..., None] * W + wids.long()[:, None, :]  # (M, F, Wp)
    hits = (bms.reshape(-1)[word] & bits[:, None, :]) != 0
    need = needed_words(hits, valid, (bits != 0)[:, None, :])
    hit = valid & hits.any(-1)
    distinct = lambda idx: torch.unique(idx).numel()  # noqa: E731
    hit_nodes = torch.unique(node[hit])
    if narrow:
        c = codes[hit_nodes].long()
        mbr_bytes = (hit_nodes.numel() * 8
                     + distinct(c[:, 0::2].clamp(0, dict_x.numel() - 1)) * 4
                     + distinct(c[:, 1::2].clamp(0, dict_y.numel() - 1)) * 4)
    else:
        mbr_bytes = hit_nodes.numel() * 16
    nbytes = (int(hit.any(1).sum()) * 8  # points of queries with a hit
              + int(need.any(1).sum()) * 8  # word pairs some slot needs
              + M * F * 4  # frontier
              + mbr_bytes  # MBRs (codes and dictionary entries) of nodes that hit
              + distinct(word[need]) * 4  # node words
              + M * F * 4)  # out
    ops = M * F + int(hit.sum()) * 11 + int(need.sum()) * 2  # id test, MBR math, AND+test
    return nbytes, ops


def fused_bound(args, query_bytes=None):
    """Leaf ids and flags in, ids and counts out for every (query, slot);
    of the selected leaf rows (each bank element once): object ids of leaves
    some valid slot selects, signatures of live objects, compact words that
    decide a signature-passing object, coordinates of keyword hits; the
    query words some object needs and ``q_sig`` of slots with a live object,
    or ``query_bytes`` in their place (``fused_remap_bound``)."""
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
    need = needed_words(hit, sig, (q_cbm != 0)[:, :, None, :])
    kw = sig & hit.any(-1)
    word = obj[..., None] * Wl + torch.arange(Wl, device=leaf.device)
    distinct = lambda idx: torch.unique(idx).numel()  # noqa: E731
    if query_bytes is None:
        query_bytes = (int(need.any(2).sum()) * 4  # query words some object needs
                       + int(live.any(-1).sum()) * 4)  # q_sig of slots with a live object
    nbytes = (int(kw.any(-1).any(-1).sum()) * 16  # rects of queries with a hit
              + query_bytes
              + M * T * (4 + 1)  # top_leaf, leaf_ok
              + distinct(leaf[ok]) * OBJ * 4  # obj_id of the selected rows
              + distinct(obj[live]) * 4  # obj_sig
              + distinct(word[need]) * 4  # obj_cbm
              + distinct(obj[kw]) * 8  # obj_x, obj_y
              + M * T * OBJ * 4 + M * T * 4)  # ids and kwv written once
    ops = (int(ok.sum()) * OBJ + int(live.sum()) * 2  # id test, sig AND+test
           + int(need.sum()) * 2 + int(kw.sum()) * 4)  # word AND+test, 4 compares
    return nbytes, ops


def fused_remap_bound(args, remap):
    """``fused_bound`` of the remapping entry (operands ``q_rects, q_bm,
    leaf_terms, top_leaf, leaf_ok`` and the bank, then the ``words`` flag),
    each byte once: no ``q_cbm``/``q_sig`` read; the ``leaf_terms`` rows of
    the distinct leaves that live slots (``leaf_ok > 0``) select, and the
    distinct (query, word) pairs of ``q_bm`` those rows name at live slots;
    with ``words`` the remapped words of every slot written out; the rest as
    ``fused_bound`` counts it on the words ``remap`` (the plain remap)
    gives."""
    q_rects, q_bm, leaf_terms, top_leaf, leaf_ok, *bank, words = args
    M, W = q_bm.shape
    K, L = leaf_terms.shape
    q_cbm, q_sig = remap(q_bm, leaf_terms, top_leaf)
    ok = leaf_ok > 0
    leaf = top_leaf.long().clamp(0, K - 1)
    terms = leaf_terms[leaf[ok]]  # (live slots, L)
    widx = terms.clamp(0, 32 * W - 1) >> 5
    qrow = torch.arange(M, device=leaf.device)[:, None].expand(M, top_leaf.shape[1])[ok]
    named = (qrow[:, None] * W + widx)[terms >= 0]
    query_bytes = (torch.unique(leaf[ok]).numel() * L * 4  # dictionary rows
                   + torch.unique(named).numel() * 4)  # query words they name
    nbytes, ops = fused_bound((q_rects, q_cbm, q_sig, top_leaf, leaf_ok, *bank), query_bytes)
    if words:
        nbytes += q_cbm.numel() * 4 + q_sig.numel() * 4
    return nbytes, ops + int((terms >= 0).sum()) * 3  # clamp, shift, and per named bit


def fused_wide_bound(args, chunk: int = 32):
    """``fused_bound`` on the full-width bank: object ids of the selected
    rows, the words that decide each live object's keyword test (each bank
    word once, however many queries need it), coordinates of keyword hits,
    and the query words some object needs. Counted ``chunk`` queries at a
    time, so the (M, T, OBJ, W) hit plane never exists whole."""
    q_rects, q_bm, top_leaf, leaf_ok, ox, oy, obm, oid = args
    M, T = top_leaf.shape
    K, OBJ = ox.shape
    W = q_bm.shape[1]
    leaf = top_leaf.long().clamp(0, K - 1)
    ok = leaf_ok > 0
    obj = leaf[..., None] * OBJ + torch.arange(OBJ, device=leaf.device)  # (M, T, OBJ)
    live = (oid.reshape(-1)[obj] >= 0) & ok[..., None]
    bank_words = torch.zeros((K * OBJ, W), dtype=torch.int32, device=leaf.device)
    kw = torch.zeros_like(live)
    q_need = n_need = 0
    for m0 in range(0, M, chunk):
        sl = slice(m0, m0 + chunk)
        hit = (obm.reshape(-1, W)[obj[sl]] & q_bm[sl, None, None, :]) != 0
        need = needed_words(hit, live[sl], (q_bm[sl] != 0)[:, None, None, :])
        kw[sl] = live[sl] & hit.any(-1)
        bank_words.index_put_((obj[sl].reshape(-1),), need.reshape(-1, W).to(torch.int32),
                              accumulate=True)
        q_need += int(need.any(2).any(1).sum())
        n_need += int(need.sum())
    distinct = lambda idx: torch.unique(idx).numel()  # noqa: E731
    nbytes = (int(kw.any(-1).any(-1).sum()) * 16  # rects of queries with a hit
              + q_need * 4  # query words some object needs
              + M * T * (4 + 1)  # top_leaf, leaf_ok
              + distinct(leaf[ok]) * OBJ * 4  # obj_id of the selected rows
              + int((bank_words > 0).sum()) * 4  # obj_bm
              + distinct(obj[kw]) * 8  # obj_x, obj_y
              + M * T * OBJ * 4 + M * T * 4)  # ids and kwv written once
    ops = int(ok.sum()) * OBJ + n_need * 2 + int(kw.sum()) * 4
    return nbytes, ops


def verify_bound(args, compact: bool):
    """Bytes and operations of an unfused verify (``verify_candidates``, or
    ``verify_candidates_compact``) of gathered candidates: every validity
    flag in and every flag out; of a valid candidate, its signature
    (compact), its coordinates where the signature passes, and the words
    that decide its keyword test where it also lies in the rectangle; query
    rectangles, signatures and words where some candidate needs them. The
    counted entries (``verify_candidates_counted``, ``..._compact_counted``:
    a last operand of ids, -1 where invalid) read and write 4-byte ids for
    the flags and write the two per-query counts besides."""
    counted = args[-1].dtype == torch.int32
    if compact:
        q_rects, q_cbm, q_sig, cx, cy, cbm, csig, cval = args
        T = q_sig.shape[1]
        obj = cx.shape[1] // T
        q_words = q_cbm.repeat_interleave(obj, dim=1)
    else:
        q_rects, q_bm, cx, cy, cbm, cval = args
        q_words = q_bm[:, None, :]
    M, C = cx.shape
    valid = cval >= 0 if counted else cval > 0
    coords = valid & ((csig & q_sig.repeat_interleave(obj, dim=1)) != 0) if compact else valid
    live = coords & ((cx >= q_rects[:, 0:1]) & (cx <= q_rects[:, 2:3])
                     & (cy >= q_rects[:, 1:2]) & (cy <= q_rects[:, 3:4]))
    need = needed_words((cbm & q_words) != 0, live, q_words != 0)  # (M, C, W)
    if compact:
        q_need = int(need.reshape(M, T, obj, -1).any(2).sum())
        sig_bytes = int(valid.sum()) * 4 + int(valid.reshape(M, T, obj).any(2).sum()) * 4
    else:
        q_need, sig_bytes = int(need.any(1).sum()), 0
    flag = 4 if counted else 1
    nbytes = (M * C * flag  # cand_valid, or the ids
              + sig_bytes  # cand_sig of valid candidates, q_sig of their slots
              + int(coords.sum()) * 8  # cand_x, cand_y
              + int(need.sum()) * 4  # candidate words
              + int(coords.any(1).sum()) * 16  # rects of queries that need them
              + q_need * 4  # query words some candidate needs
              + M * C * flag + (M * 8 if counted else 0))  # out
    ops = M * C + int(valid.sum()) * (2 if compact else 0) + int(coords.sum()) * 4 \
        + int(need.sum()) * 2
    return nbytes, ops


def slot_verify_bound(args, compact: bool, chunk: int = 32):
    """Bytes and operations of a slot verify (``verify_slots``, or
    ``compact``, ``verify_slots_compact``) that reads the slot bank itself:
    every (query, slot) leaf id and flag in; the id of each slot of a
    selected leaf (each bank slot once, however many queries select it); of
    a valid slot, its signature (compact) and the words that decide its
    keyword test (each bank word once); the coordinates of keyword hits;
    the rectangles of queries with a keyword hit; the query words: compact,
    the per-slot words some slot needs and the signatures of (query, slot)
    pairs with a valid slot; full width, the W words of each query with a
    valid slot, which the kernel reads whole to compact them; the ids and
    both counts out. Counted ``chunk`` queries at a time, so the
    (M, T, B, W) hit plane never exists whole."""
    if compact:
        q_rects, q_words, q_sig, top_leaf, leaf_ok, x, y, words, sig, sid = args
    else:
        q_rects, q_words, top_leaf, leaf_ok, x, y, words, sid = args
    M, T = top_leaf.shape
    K, B = sid.shape
    W = words.shape[2]
    dev = sid.device
    leaf = top_leaf.long().clamp(0, K - 1)
    ok = (leaf_ok > 0)[..., None].expand(M, T, B)
    slot = leaf[..., None] * B + torch.arange(B, device=dev)  # (M, T, B)
    valid = ok & (sid.reshape(-1)[slot] >= 0)
    live = valid & ((sig.reshape(-1)[slot] & q_sig[..., None]) != 0) if compact else valid
    bank_words = torch.zeros(K * B * W, dtype=torch.bool, device=dev)
    kw = torch.zeros_like(valid)
    cols = torch.arange(W, device=dev)
    q_need = n_need = 0
    for m0 in range(0, M, chunk):
        sl = slice(m0, m0 + chunk)
        qw = q_words[sl][:, :, None, :] if compact else q_words[sl][:, None, None, :]
        hit = (words.reshape(-1, W)[slot[sl]] & qw) != 0  # (c, T, B, W)
        need = needed_words(hit, live[sl], qw != 0)
        kw[sl] = live[sl] & hit.any(-1)
        bank_words[(slot[sl][..., None] * W + cols)[need]] = True
        q_need += int(need.any(2).sum())
        n_need += int(need.sum())
    distinct = lambda idx: torch.unique(idx).numel()  # noqa: E731
    if compact:  # per-slot query words some slot needs, q_sig of pairs with a valid slot
        q_bytes = q_need * 4 + int(valid.any(-1).sum()) * 4
        sig_bytes = distinct(slot[valid]) * 4
    else:  # the W words of each query with a valid slot, read whole
        q_bytes, sig_bytes = int(valid.any(-1).any(-1).sum()) * W * 4, 0
    nbytes = (M * T * (4 + 1)  # top_leaf, leaf_ok
              + distinct(slot[ok]) * 4  # ids of the selected leaves' slots
              + sig_bytes  # slot signatures of valid slots
              + int(bank_words.sum()) * 4  # slot words
              + distinct(slot[kw]) * 8  # coordinates of keyword hits
              + int(kw.any(-1).any(-1).sum()) * 16  # rectangles of queries with a hit
              + q_bytes
              + M * T * B * 4 + M * 8)  # ids, n_match and n_kw written once
    ops = (int(ok.sum()) + int(valid.sum()) * (2 if compact else 0)  # id test, sig AND+test
           + n_need * 2 + int(kw.sum()) * 4)  # word AND+test, 4 compares
    return nbytes, ops


def filter_bound(args, chunk: int = 32):
    """Bytes and operations of the dense filter (``skr_filter``): every
    query rectangle and node MBR in and every flag out; the words that
    decide a pair whose rectangles meet (each node word once, however many
    queries need it) and the query words some pair needs. Counted ``chunk``
    queries at a time, so the (M, K, W) hit plane never exists whole."""
    q_rects, q_bm, n_mbrs, n_bm = args
    M, W = q_bm.shape
    K = n_mbrs.shape[0]
    node_words = torch.zeros((K, W), dtype=torch.bool, device=q_bm.device)
    q_need = n_need = n_meet = 0
    for m0 in range(0, M, chunk):
        qr = q_rects[m0:m0 + chunk, None, :]
        meet = ((qr[..., 0] <= n_mbrs[:, 2]) & (n_mbrs[:, 0] <= qr[..., 2])
                & (qr[..., 1] <= n_mbrs[:, 3]) & (n_mbrs[:, 1] <= qr[..., 3]))  # (c, K)
        qb = q_bm[m0:m0 + chunk, None, :]
        need = needed_words((qb & n_bm) != 0, meet, qb != 0)  # (c, K, W)
        node_words |= need.any(0)
        q_need += int(need.any(1).sum())
        n_need += int(need.sum())
        n_meet += int(meet.sum())
    nbytes = M * 16 + K * 16 + q_need * 4 + int(node_words.sum()) * 4 + M * K
    ops = M * K * 4 + n_need * 2
    return nbytes, ops


def sub_bound(args, chunk: int = 16):
    """Bytes and operations of ``sub_match``: every object point and
    subscription rectangle in; the signatures of objects and subscriptions
    with a pair inside the rectangle; of the pairs that also pass the
    signature test, the object words (id and value) and the subscription
    words (each once) that decide them; and the output. The matrix
    instance's 7 packed operands write the (N, S) flags; the pairs
    instance's 5 full-width ones (objects' words counted as their packed
    nonzero words and folded signature) write 8 B per matching pair.
    Operations: the points sorted by x and each rectangle's span found in
    them (log2 N compares each), the x test of the pairs whose x lies in
    the span, and the y, signature and word tests that this data needs."""
    if len(args) == 5:
        from repro_torch.kernels.ref import nonzero_words, or_fold

        o_pts, o_bm, s_rects, s_bm, s_sig = args
        (o_wids, o_bits), o_sig = nonzero_words(o_bm), or_fold(o_bm)
    else:
        o_pts, o_wids, o_bits, o_sig, s_rects, s_bm, s_sig = args
    N, Wp = o_wids.shape
    S, W = s_bm.shape
    sub_words = torch.zeros(S * W, dtype=torch.bool, device=s_bm.device)
    s_in = torch.zeros(S, dtype=torch.bool, device=s_bm.device)
    o_in = o_need = n_need = n_in = n_match = n_x = 0
    s_cols = torch.arange(S, device=s_bm.device)[None, :, None] * W
    for n0 in range(0, N, chunk):
        x, y = o_pts[n0:n0 + chunk, 0:1], o_pts[n0:n0 + chunk, 1:2]
        in_x = (x >= s_rects[:, 0]) & (x <= s_rects[:, 2])
        inr = in_x & (y >= s_rects[:, 1]) & (y <= s_rects[:, 3])
        live = inr & ((o_sig[n0:n0 + chunk, None] & s_sig[None, :]) != 0)  # (c, S)
        wid = o_wids[n0:n0 + chunk].long()  # (c, Wp)
        g = s_bm.t()[wid]  # (c, Wp, S)
        hits = ((g & o_bits[n0:n0 + chunk, :, None]) != 0).transpose(1, 2)  # (c, S, Wp)
        need = needed_words(hits, live, (o_bits[n0:n0 + chunk] != 0)[:, None, :])
        sub_words[(s_cols + wid[:, None, :])[need]] = True
        s_in |= inr.any(0)
        o_in += int(inr.any(1).sum())
        o_need += int(need.any(1).sum())
        n_need += int(need.sum())
        n_in += int(inr.sum())
        n_match += int((live & hits.any(-1)).sum())
        n_x += int(in_x.sum())
    out = n_match * 8 if len(args) == 5 else N * S
    nbytes = (N * 8 + S * 16  # points, rectangles
              + o_in * 4 + int(s_in.sum()) * 4  # signatures where a pair is in the rectangle
              + o_need * 8  # object words (id, value) some pair needs
              + int(sub_words.sum()) * 4  # subscription words
              + out)  # flags, or 8 B a matching pair
    log_n = max(N - 1, 1).bit_length()
    ops = (N + S) * log_n + n_x * 4 + n_in * 2 + n_need * 2
    return nbytes, ops


def cdf_bound(args):
    """Bytes (the points and the weights in, the (N, B) CDF plane out) and
    flops (2 N B (H + 2 H^2 + H)) of the CDF-MLP bank."""
    params, x = args
    B, _, H = params["w0"].shape
    N = x.shape[0]
    nbytes = N * 4 + sum(t.numel() for t in params.values()) * 4 + N * B * 4
    return nbytes, 2 * N * B * (H + 2 * H * H + H)


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_batch(label: str, serve_one, warm, plan_cache_cls) -> None:
    """Where one warm batch's time goes: ``torch.profiler`` over a single
    serving call, device time by operation against the host clock."""
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
    copy_ms = sum(dev(e) for e in on_device if e.key.startswith(("Memcpy", "Memset")))
    log(f"profile of one {label} batch (profiler on): wall {wall_ms:.6f} ms, device busy "
        f"{busy_ms:.6f} ms ({100 * busy_ms / wall_ms:.3f} %), "
        f"device idle {100 - 100 * busy_ms / wall_ms:.3f} %, "
        f"{sum(e.count for e in on_device)} device events; copies and sets {copy_ms:.6f} ms, "
        f"other device work {busy_ms - copy_ms:.6f} ms")
    for e in sorted(on_device, key=dev, reverse=True)[:8]:
        log(f"  device {dev(e):.6f} ms x{e.count}: {e.key[:100]}")
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        log(f"  host {e.self_cpu_time_total / 1e3:.6f} ms x{e.count}: {e.key[:100]}")


# --------------------------------------------------------- ragged operands
def _words(g, *shape):
    return (g.integers(0, 2 ** 32, shape, dtype=np.uint32)
            * g.integers(0, 2, shape, dtype=np.uint32)).view(np.int32)


def ragged_slots(dev, narrow: bool, knn: bool, M=37, F=131, W=3, D=61, seed=5):
    """Operands of a frontier (``knn=False``: query rectangles) or kNN
    filter (query points) at ragged shapes: int16 rank codes into two sorted
    dictionaries (``narrow``) or the f32 MBRs they decode to, sparse random
    words, random validity and an all-invalid last row."""
    g = np.random.default_rng(seed)
    dx = np.sort(g.uniform(0, 1, D)).astype(np.float32)
    dy = np.sort(g.uniform(0, 1, D)).astype(np.float32)
    lo = g.integers(0, D, (M, F, 2))
    hi = np.minimum(lo + g.integers(0, 8, (M, F, 2)), D - 1)
    codes = np.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]], -1).astype(np.int16)
    qlo = g.uniform(0, 0.8, (M, 2)).astype(np.float32)
    rects = np.concatenate([qlo, qlo + g.uniform(0.01, 0.3, (M, 2)).astype(np.float32)], 1)
    valid = g.integers(0, 2, (M, F)).astype(np.int8)
    if M > 1:
        valid[-1] = 0
    q = g.uniform(0, 1, (M, 2)).astype(np.float32) if knn else rects
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    qw, fw = t(_words(g, M, W)), t(_words(g, M, F, W))
    if narrow:
        return (t(q), qw, t(codes), fw, t(valid), t(dx), t(dy))
    mbrs = np.stack([dx[codes[..., 0]], dy[codes[..., 1]], dx[codes[..., 2]], dy[codes[..., 3]]], -1)
    return (t(q), qw, t(mbrs), fw, t(valid))


def ragged_fused(dev, M=13, T=5, K=11, OBJ=37, Wl=2, seed=7, W=None):
    """Compact fused-verify operands at ragged shapes: dirty leaf ids,
    ``leaf_ok = 0`` slots, -1 id pads. Without ``W``, the given-words form
    (random ``q_cbm`` and its OR-fold ``q_sig``); with ``W``, the remapping
    entry's ``(q_bm, leaf_terms)`` form followed by ``words=True``: leaf
    dictionaries of even term ids, a quarter ``-1`` pads, a tenth past bit
    32*W - 1 (the remap clamps them) and an all-``-1`` last one; a first
    query whose bits are odd term ids, in no dictionary (``q_sig == 0`` in
    every slot), an all-ones second one, and a last of ``leaf_ok = 0``
    slots only."""
    g = np.random.default_rng(seed)
    words = lambda *s: _words(g, *s)  # noqa: E731
    qlo = g.uniform(0, 0.8, (M, 2)).astype(np.float32)
    rects = np.concatenate([qlo, qlo + g.uniform(0.01, 0.3, (M, 2)).astype(np.float32)], 1)
    cbm = words(K, OBJ, Wl)
    sig = np.bitwise_or.reduce(cbm.view(np.uint32), axis=-1).view(np.int32)
    oid = np.where(g.integers(0, 4, (K, OBJ)) > 0, g.integers(0, 10_000, (K, OBJ)), -1)
    leaf_ok = g.integers(0, 2, (M, T)).astype(np.int8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    if W is None:
        q_cbm = words(M, T, Wl)
        q_sig = np.bitwise_or.reduce(q_cbm.view(np.uint32), axis=-1).view(np.int32)
        query = (t(q_cbm), t(q_sig))
    else:
        nbits = 32 * W
        terms = 2 * g.integers(0, max(nbits // 2, 1), (K, 32 * Wl))
        clamped = g.integers(0, 10, terms.shape) == 0  # entries past the bitmap's bits
        terms = np.where(clamped, nbits + g.integers(0, 64, terms.shape), terms)
        terms = np.where(g.integers(0, 4, terms.shape) == 0, -1, terms)
        q_bm = words(M, W).view(np.uint32)
        if K > 1:
            terms[-1] = -1
        if M > 1:
            odd = np.arange(1, nbits - 1, 2)
            q_bm[0] = 0
            np.bitwise_or.at(q_bm[0], odd >> 5, np.uint32(1) << (odd & 31).astype(np.uint32))
            leaf_ok[-1] = 0
        if M > 2:
            q_bm[1] = np.uint32(0xFFFFFFFF)
        query = (t(q_bm.view(np.int32)), t(terms.astype(np.int32)))
    bank = (t(g.integers(-2, K + 3, (M, T)).astype(np.int32)), t(leaf_ok),
            t(g.uniform(0, 1, (K, OBJ)).astype(np.float32)),
            t(g.uniform(0, 1, (K, OBJ)).astype(np.float32)),
            t(cbm), t(sig), t(oid.astype(np.int32)))
    return (t(rects), *query, *bank) + (() if W is None else (True,))


def _terms(g, n, W, pool, lo, hi):
    """(n, W) u32 bitmaps of ``lo`` to ``hi - 1`` terms each from ``pool``."""
    bm = np.zeros((n, W), np.uint32)
    for r in range(n):
        picks = g.choice(pool, size=min(int(g.integers(lo, hi)), pool.size), replace=False)
        np.bitwise_or.at(bm[r], picks >> 5, np.uint32(1) << (picks & 31).astype(np.uint32))
    return bm


def _query_words(g, ops, M, W, pool, sparse):
    """Query bitmaps -- dense random words (Wp = W at small W), or up to
    three pool terms each (Wp below W at wide W) -- the first query with no
    nonzero word, and their packing as int32 tensors' arrays."""
    q_bm = _words(g, M, W).view(np.uint32) if not sparse else _terms(g, M, W, pool, 1, 4)
    if M > 1:
        q_bm[0] = 0
    wids, bits = ops.pack_query_words(q_bm)
    return q_bm.view(np.int32), wids, bits.view(np.int32)


def ragged_fused_wide(dev, ops, M=13, T=5, K=11, OBJ=37, W=3, sparse=False, seed=7):
    """Full-width fused-verify operands at ragged shapes, and the queries'
    packed words as a last ``(wids, bits)`` operand: dirty leaf ids, invalid
    slots, -1 id pads, a ``NEVER_RECT`` query and one with no nonzero word
    (with sparse queries, the bank's objects share their term pool)."""
    g = np.random.default_rng(seed)
    qlo = g.uniform(0, 0.8, (M, 2)).astype(np.float32)
    rects = np.concatenate([qlo, qlo + g.uniform(0.01, 0.3, (M, 2)).astype(np.float32)], 1)
    if M > 1:
        rects[-1] = ops.NEVER_RECT
    oid = np.where(g.integers(0, 4, (K, OBJ)) > 0, g.integers(0, 10_000, (K, OBJ)), -1)
    pool = g.choice(32 * W, size=min(32 * W, 24), replace=False)
    q_bm, wids, bits = _query_words(g, ops, M, W, pool, sparse)
    obj_bm = (_terms(g, K * OBJ, W, pool, 0, 5).reshape(K, OBJ, W).view(np.int32) if sparse
              else _words(g, K, OBJ, W))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(rects), t(q_bm), t(g.integers(-2, K + 3, (M, T)).astype(np.int32)),
            t(g.integers(0, 2, (M, T)).astype(np.int8)),
            t(g.uniform(0, 1, (K, OBJ)).astype(np.float32)),
            t(g.uniform(0, 1, (K, OBJ)).astype(np.float32)),
            t(obj_bm), t(oid.astype(np.int32)), (t(wids), t(bits)))


# query points with NaN or infinite coordinates, None keeping one
NONFINITE_POINTS = [(float("nan"), None), (float("inf"), None), (-float("inf"), -float("inf")),
                    (None, float("nan"))]


def ragged_level(dev, ops, M=37, F=131, N=53, W=3, sparse=False, seed=19, D=None,
                 nonfinite=False):
    """``knn_level_dist`` operands at ragged shapes: one level of N nodes
    with a few pool terms each, an (M, F) frontier with -1 pads, dirty ids
    past N - 1 and a last row of padding only, and packed query words
    (``_query_words``). With ``D``, ``knn_level_dist_narrow``'s: the MBRs
    as int16 rank codes into two sorted dictionaries of D entries, which
    come last. ``nonfinite``: ``NONFINITE_POINTS`` over the first query
    points (a NaN x first)."""
    g = np.random.default_rng(seed)
    pool = g.choice(32 * W, size=min(32 * W, 48), replace=False)
    _, wids, bits = _query_words(g, ops, M, W, pool, sparse)
    lo = g.uniform(0, 1, (N, 2)).astype(np.float32)
    mbrs = np.concatenate([lo, lo + g.uniform(0, 0.3, (N, 2)).astype(np.float32)], 1)
    frontier = g.integers(0, N + 3, (M, F)).astype(np.int32)
    frontier[g.uniform(0, 1, (M, F)) < 0.3] = -1
    if M > 1:
        frontier[-1] = -1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pts, bms = g.uniform(0, 1, (M, 2)).astype(np.float32), _terms(g, N, W, pool, 0, 7)
    for r, pat in enumerate(NONFINITE_POINTS[:M] if nonfinite else []):
        for c, v in enumerate(pat):
            if v is not None:
                pts[r, c] = v
    if D is None:
        return (t(pts), t(wids), t(bits), t(mbrs), t(bms.view(np.int32)), t(frontier))
    dx, dy = (np.sort(g.uniform(0, 1, D)).astype(np.float32) for _ in range(2))
    c_lo = g.integers(0, D, (N, 2))
    c_hi = np.minimum(c_lo + g.integers(0, 8, (N, 2)), D - 1)
    codes = np.stack([c_lo[:, 0], c_lo[:, 1], c_hi[:, 0], c_hi[:, 1]], -1).astype(np.int16)
    return (t(pts), t(wids), t(bits), t(codes), t(bms.view(np.int32)), t(frontier), t(dx),
            t(dy))


def ragged_frontier_level(dev, ops, M=37, F=131, N=53, W=3, sparse=False, seed=31, D=None):
    """``frontier_level`` operands at ragged shapes: query rectangles (the
    second ``NEVER_RECT``, which meets nothing) and bitmaps
    (``_query_words``: the first with no nonzero word), one level of N nodes
    with a few pool terms each, and an (M, F) frontier with -1 pads, dirty
    ids past N - 1 and a last row of padding only. The term pool lies in the
    last 100 words, so past 2,048 words (one compaction round) the nodes'
    terms fall on both sides of a round's edge. With ``D``,
    ``frontier_level_narrow``'s: the MBRs as int16 rank codes into two
    sorted dictionaries of D entries, which come last."""
    g = np.random.default_rng(seed)
    lo_word = max(0, W - 100)
    pool = 32 * lo_word + g.choice(32 * (W - lo_word), size=min(32 * (W - lo_word), 48),
                                   replace=False)
    q_bm, _, _ = _query_words(g, ops, M, W, pool, sparse)
    rects = _rects(g, M)
    rects[:, 2:] += np.float32(0.1)
    if M > 2:
        rects[1] = ops.NEVER_RECT
    frontier = g.integers(0, N + 3, (M, F)).astype(np.int32)
    frontier[g.uniform(0, 1, (M, F)) < 0.3] = -1
    if M > 1:
        frontier[-1] = -1
    bms = _terms(g, N, W, pool, 0, 7).view(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    if D is None:
        lo = g.uniform(0, 1, (N, 2)).astype(np.float32)
        mbrs = np.concatenate([lo, lo + g.uniform(0, 0.3, (N, 2)).astype(np.float32)], 1)
        return (t(rects), t(q_bm), t(mbrs), t(bms), t(frontier))
    dx, dy = (np.sort(g.uniform(0, 1, D)).astype(np.float32) for _ in range(2))
    c_lo = g.integers(0, D, (N, 2))
    c_hi = np.minimum(c_lo + g.integers(0, 8, (N, 2)), D - 1)
    codes = np.stack([c_lo[:, 0], c_lo[:, 1], c_hi[:, 0], c_hi[:, 1]], -1).astype(np.int16)
    return (t(rects), t(q_bm), t(codes), t(bms), t(frontier), t(dx), t(dy))


def ragged_verify(dev, compact: bool, M=13, T=5, OBJ=37, W=3, seed=11):
    """Unfused verify operands at ragged shapes: T slots of OBJ candidates
    (half of them inside their query's rectangle), W (or, compact, Wl)
    words, random validity and an all-invalid last row."""
    g = np.random.default_rng(seed)
    C = T * OBJ
    qlo = g.uniform(0, 0.8, (M, 2)).astype(np.float32)
    rects = np.concatenate([qlo, qlo + g.uniform(0.01, 0.3, (M, 2)).astype(np.float32)], 1)
    inside = g.uniform(0, 1, (2, M, C)).astype(np.float32)
    cx = np.where(inside[0] < 0.5, rects[:, 0:1] + inside[0] * 2 * (rects[:, 2:3] - rects[:, 0:1]),
                  g.uniform(0, 1, (M, C))).astype(np.float32)
    cy = np.where(inside[1] < 0.5, rects[:, 1:2] + inside[1] * 2 * (rects[:, 3:4] - rects[:, 1:2]),
                  g.uniform(0, 1, (M, C))).astype(np.float32)
    valid = g.integers(0, 2, (M, C)).astype(np.int8)
    if M > 1:
        valid[-1] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    if not compact:
        return (t(rects), t(_words(g, M, W)), t(cx), t(cy), t(_words(g, M, C, W)), t(valid))
    fold = lambda w: np.bitwise_or.reduce(w.view(np.uint32), axis=-1).view(np.int32)  # noqa: E731
    q_cbm, cbm = _words(g, M, T, W), _words(g, M, C, W)
    return (t(rects), t(q_cbm), t(fold(q_cbm)), t(cx), t(cy), t(cbm), t(fold(cbm)), t(valid))


def ragged_slot_bank(dev, ops, compact, M=13, T=5, K=11, B=8, W=3, seed=41, empty=False):
    """Slot-verify operands at ragged shapes: a bank of K leaves x B slots,
    about a third empty (``empty``: all), points near the query rectangles
    with some exactly on their edges; dirty leaf ids (-2 to past K),
    ``leaf_ok = 0`` slots and an all-zero last row; a first query with no
    nonzero word and a ``NEVER_RECT`` second one. Compact: per-slot query
    words and OR-fold signatures."""
    g = np.random.default_rng(seed)
    rects = _rects(g, M)
    near = rects[g.integers(0, M, K)]  # (K, 4): each leaf's points near one query
    u = g.uniform(0, 1, (2, K, B)).astype(np.float32)
    x = (near[:, 0:1] + u[0] * 2 * (near[:, 2:3] - near[:, 0:1])).astype(np.float32)
    y = (near[:, 1:2] + u[1] * 2 * (near[:, 3:4] - near[:, 1:2])).astype(np.float32)
    on_edge = g.integers(0, 6, (K, B)) == 0
    x = np.where(on_edge, near[:, 2:3], x).astype(np.float32)
    ids = np.where(g.integers(0, 3, (K, B)) > 0, g.integers(0, 10 * K * B, (K, B)), -1)
    if empty:
        ids[:] = -1
    top_leaf = g.integers(-2, K + 3, (M, T)).astype(np.int32)
    leaf_ok = g.integers(0, 2, (M, T)).astype(np.int8)
    leaf_ok[-1] = 0
    q_words = _words(g, M, T, W) if compact else _words(g, M, W)
    q_words[0] = 0
    rects[1] = ops.NEVER_RECT
    fold = lambda w: np.bitwise_or.reduce(w.view(np.uint32), axis=-1).view(np.int32)  # noqa: E731
    words = _words(g, K, B, W)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    head = (rects, q_words, fold(q_words)) if compact else (rects, q_words)
    bank = (x, y, words, fold(words)) if compact else (x, y, words)
    return tuple(t(a) for a in head + (top_leaf, leaf_ok) + bank + (ids.astype(np.int32),))


def _rects(g, n):
    lo = g.uniform(0, 0.8, (n, 2)).astype(np.float32)
    return np.concatenate([lo, lo + g.uniform(0.01, 0.3, (n, 2)).astype(np.float32)], 1)


def ragged_filter(dev, never_rect, M=37, K=131, W=3, seed=13, sparse=False):
    """Dense-filter operands at ragged shapes: a ``NEVER_RECT`` node, a node
    and a query with empty bitmaps, a zero-area query on a node's corner;
    ``sparse``: one to three terms a row, so that most word tests miss."""
    g = np.random.default_rng(seed)
    q_rects, n_mbrs = _rects(g, M), _rects(g, K)
    if sparse:
        pool = np.arange(32 * W)
        q_bm, n_bm = (_terms(g, n, W, pool, 1, 4).view(np.int32) for n in (M, K))
    else:
        q_bm, n_bm = _words(g, M, W), _words(g, K, W)
    if K > 1:
        n_mbrs[0] = never_rect
        n_bm[-1] = 0
    if M > 1:
        q_bm[-1] = 0
        q_rects[0] = np.concatenate([n_mbrs[K // 2, 2:], n_mbrs[K // 2, 2:]])
        q_bm[0] = n_bm[K // 2]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(q_rects), t(q_bm), t(n_mbrs), t(n_bm))


def ragged_sub(dev, ops, N=37, S=131, W=3, seed=17, pairs=False, late=False):
    """``sub_match`` operands at ragged shapes, packed as
    ``match_subscriptions`` packs them (``pairs``: the pairs instance's
    full-width ones): ``NEVER_RECT`` and zero-area subscriptions, empty
    bitmaps on both sides, points on rectangle edges. ``late``: every
    object word nonzero, and each subscription's one word past the 32nd a
    bit of an object's there or another, so that matches are decided past
    the words the pairs instance stages."""
    g = np.random.default_rng(seed)
    s_rects = _rects(g, S)
    s_bm = _words(g, S, W).view(np.uint32)
    o_bm = _words(g, N, W).view(np.uint32)
    pts = g.uniform(0, 1, (N, 2)).astype(np.float32)
    if late:
        o_bm = np.uint32(1) << g.integers(0, 32, (N, W)).astype(np.uint32)
        cols = g.integers(32, W, S)
        s_bm = np.zeros((S, W), np.uint32)
        s_bm[np.arange(S), cols] = np.where(g.random(S) < 0.5, o_bm[g.integers(0, N, S), cols],
                                            np.uint32(1) << g.integers(0, 32, S).astype(np.uint32))
        s_rects[::3] = (0.0, 0.0, 1.0, 1.0)
    if S > 2:
        s_rects[0] = ops.NEVER_RECT
        s_rects[1, 2:] = s_rects[1, :2]  # zero area
        s_bm[2] = 0
    if N > 2:
        pts[0] = s_rects[S // 2, 2:]  # a corner
        pts[1] = s_rects[min(1, S - 1), :2]
        o_bm[2] = 0
    fold = lambda w: np.bitwise_or.reduce(w, axis=1).view(np.int32)  # noqa: E731
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    block = (t(s_rects), t(s_bm.view(np.int32)), t(fold(s_bm)))
    if pairs:
        return (t(pts), t(o_bm.view(np.int32))) + block
    wids, bits = ops.pack_query_words(o_bm)
    return (t(pts), t(wids), t(bits.view(np.int32)), t(fold(o_bm))) + block


# the CDF bank's edge points: NaN, both infinities, both zeros, and finite
# points far enough out that a He-scale bank's outputs saturate or no
# longer depend on x
CDF_EDGE_X = (float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 1e6, -1e6, 3e7, -3e7)


def cdf_bank(dev, B, H, gen, x=None, N=1001, edges=False):
    """``(params, x)``: a bank of B MLPs 1->H->H->H->1 at ``mlp_init``'s He
    scale (weights N(0, 2/fan_in)) with biases N(0, 0.1^2), all drawn from
    ``gen``; ``x`` defaults to N uniform points. ``edges``: a copy of ``x``
    with ``CDF_EDGE_X`` over as many points, spread over it."""
    dims = dict(w0=(B, 1, H), b0=(B, H), w1=(B, H, H), b1=(B, H), w2=(B, H, H), b2=(B, H),
                w3=(B, H, 1), b3=(B, 1))
    params = {}
    for k, shape in dims.items():
        scale = (2.0 / shape[1]) ** 0.5 if k[0] == "w" else 0.1
        params[k] = (torch.randn(shape, generator=gen) * scale).to(dev)
    if x is None:
        x = torch.rand(N, generator=gen).to(dev)
    if edges:
        k = min(x.numel(), len(CDF_EDGE_X))
        x = x.clone()
        x[torch.arange(k, device=x.device) * x.numel() // k] = torch.tensor(
            CDF_EDGE_X[:k], dtype=x.dtype, device=x.device)
    return params, x


def query_points(wl) -> np.ndarray:
    """kNN query points: the centres of the workload's rectangles."""
    return np.stack(
        [(wl.rects[:, 0] + wl.rects[:, 2]) / 2, (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1
    ).astype(np.float32)


def assert_outputs_equal(got, want, what: str) -> None:
    """Two serving outputs equal on every key, dtype, shape and value."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys differ ({sorted(got)} vs {sorted(want)})")
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{what}: {k} differs")


def check_knn_oracle(knn_query, index, ds, out, points, bms, rows, k: int, what: str) -> None:
    """ids and dist2 of ``rows`` bit-equal to the host best-first oracle."""
    for q in rows:
        r = knn_query(index, ds, points[q], bms[q], k)
        row = out["ids"][q]
        if not np.array_equal(row[row >= 0], r.ids):
            raise AssertionError(f"{what} query {q}: ids differ from knn_query")
        if not np.array_equal(out["dist2"][q][: r.ids.size], r.dist2):
            raise AssertionError(f"{what} query {q}: dist2 differs from knn_query")
        if (row[r.ids.size:] != -1).any():
            raise AssertionError(f"{what} query {q}: more ids than knn_query")


def check_skr_oracle(execute_serial, index, ds, wl, out, rows, what: str):
    """ids, ``nodes_checked`` and ``verified`` of ``rows`` (queries of ``wl``
    without overflow) equal to the host oracle ``execute_serial``, whose
    stats it returns."""
    st = execute_serial(index, ds, wl.subset(rows))
    for j, q in enumerate(rows):
        row = out["ids"][q]
        if not np.array_equal(np.sort(row[row >= 0]), np.sort(st.results[j])):
            raise AssertionError(f"{what} query {q}: ids differ from execute_serial")
    if not np.array_equal(out["nodes_checked"][rows], st.nodes_accessed):
        raise AssertionError(f"{what}: nodes_checked differs from execute_serial")
    if not np.array_equal(out["verified"][rows], st.verified):
        raise AssertionError(f"{what}: verified differs from execute_serial")
    return st


def eq1(out) -> np.ndarray:
    """Per-query Eq. 1 cost of served outputs: 0.1 * nodes_checked + verified."""
    return 0.1 * out["nodes_checked"].astype(np.float64) + out["verified"]


def construction(dev, ds, wl, batches, str_out) -> None:
    """The construction phase: ``build_wisk`` at full size on the card, the
    learned index served against ``execute_serial`` and its Eq. 1 cost
    beside the STR R-tree's (``str_out``: the STR main path's outputs on
    the same batches), twin builds at the profile's own size, an
    accelerated build and a served warm-start rebuild."""
    from repro_torch.core.build import BuildConfig, build_wisk, warm_start_rebuild
    from repro_torch.core.query import execute_serial
    from repro_torch.data.synth import make_dataset
    from repro_torch.data.workloads import make_workload
    from repro_torch.launch.wisk_serve import serve_batch
    from repro_torch.serve.plan import PlanCache
    from repro_torch.serve.snapshot import IndexSnapshot

    def build(data, train, what, **cfg):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        art = build_wisk(data, train, BuildConfig(**cfg), device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        bank = art.bank
        log(f"{what}: {total:.3f} s; phase s {json.dumps(art.timings)}")
        log(f"  counters {json.dumps(art.counters)}")
        log(f"  K={art.partition.clusters.k} level widths {[l.n for l in art.index.levels]}; leaf "
            f"sizes max {int(art.partition.clusters.sizes().max())} mean "
            f"{float(art.partition.clusters.sizes().mean()):.1f}; bank B="
            f"{0 if bank.nn_params is None else bank.nn_params['w0'].shape[0]} MLPs, "
            f"E={bank.n_entries} entries, final loss {bank.train_loss:.9f}; packed levels' n_upper "
            f"{[p.n_upper for p in art.hierarchy.packs] if art.hierarchy else []}")
        log(f"  peak device memory {torch.cuda.max_memory_allocated()} B "
            f"({torch.cuda.max_memory_allocated() - start} B above the build's start)")
        return art

    def serve(snap, rects, bms, rows):
        cache = PlanCache()
        outs, times = [], []
        for b in rows:
            serve_batch(snap, rects[b], bms[b], MAX_LEAVES, plan_cache=cache)  # learn the widths
        for b in rows:
            t = time.perf_counter()
            outs.append(serve_batch(snap, rects[b], bms[b], MAX_LEAVES, plan_cache=cache))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return outs, times

    # the full-size build: train on one sample of the distribution, serve another
    train = make_workload(ds, m=N_TRAIN, dist="MIX", seed=3)
    art = build(ds, train, f"build_wisk {PROFILE} n={ds.n}, MIX m={train.m} seed 3, BuildConfig()")
    t = time.perf_counter()
    snap = IndexSnapshot.build(art.index, ds, device=dev)
    torch.cuda.synchronize()
    log(f"learned snapshot: {time.perf_counter() - t:.3f} s, {snap.nbytes()} B on the device, "
        f"OBJ={snap.obj_per_leaf} has_compact_bank={snap.has_compact_bank} "
        f"has_narrow_planes={snap.has_narrow_planes}")
    outs, times = serve(snap, wl.rects, wl.kw_bitmap, batches)
    log(f"learned index serve_batch x{len(batches)}: batch s {times}")
    rows = np.flatnonzero(outs[0]["overflow"] == 0)
    if rows.size < N_ORACLE:
        raise AssertionError(f"only {rows.size} queries of the first batch without overflow")
    t = time.perf_counter()
    check_skr_oracle(execute_serial, art.index, ds, wl.subset(batches[0]), outs[0], rows,
                     "learned index")
    log(f"learned index: the first batch's {rows.size} queries without overflow equal "
        f"execute_serial ({time.perf_counter() - t:.3f} s)")
    cat = {k: np.concatenate([o[k] for o in outs]) for k in ("nodes_checked", "verified", "overflow")}
    ref = {k: np.concatenate([o[k] for o in str_out]) for k in ("nodes_checked", "verified", "overflow")}
    both = (cat["overflow"] == 0) & (ref["overflow"] == 0)
    log(f"Eq. 1 per query (0.1 * nodes_checked + verified, max_leaves={MAX_LEAVES}) on the "
        f"{wl.m} served queries: learned {float(eq1(cat).mean()):.6f} (overflow "
        f"{int((cat['overflow'] > 0).sum())}), STR R-tree {float(eq1(ref).mean()):.6f} (overflow "
        f"{int((ref['overflow'] > 0).sum())}); on the {int(both.sum())} without overflow in "
        f"either: learned {float(eq1(cat)[both].mean()):.6f}, STR {float(eq1(ref)[both].mean()):.6f}")
    del snap, outs

    # twin builds at the profile's own size: the same config gives the same index
    small = make_dataset(PROFILE, n=N_TWIN, seed=SEED)
    strain = make_workload(small, m=N_TRAIN, dist="MIX", seed=3)
    twins = [build(small, strain, f"twin build {i} n={small.n}") for i in (1, 2)]
    a, b = twins
    if not np.array_equal(a.partition.clusters.assign, b.partition.clusters.assign):
        raise AssertionError("twin builds: partitions differ")
    if len(a.hierarchy.parents) != len(b.hierarchy.parents) or not all(
            np.array_equal(x, y) for x, y in zip(a.hierarchy.parents, b.hierarchy.parents)):
        raise AssertionError("twin builds: hierarchies differ")
    if a.bank.train_loss != b.bank.train_loss or not all(
            torch.equal(a.bank.nn_params[k], b.bank.nn_params[k]) for k in a.bank.nn_params):
        raise AssertionError("twin builds: banks differ")
    log("twin builds: equal partition, hierarchy parents and bank, bit for bit")
    build(small, strain, f"accelerated build n={small.n}", accelerated=True)

    # a warm-start rebuild for a shifted workload, leaves regressed detected
    shifted = make_workload(small, m=N_TRAIN, dist="GAU", seed=4)
    torch.cuda.synchronize()
    t = time.perf_counter()
    warm = warm_start_rebuild(small, shifted, a, device=dev)
    torch.cuda.synchronize()
    log(f"warm_start_rebuild (GAU m={shifted.m} seed 4): {time.perf_counter() - t:.3f} s; "
        f"refined_leaves={warm.counters['refined_leaves']} kept_clusters="
        f"{warm.counters['kept_clusters']}; phase s {json.dumps(warm.timings)}; counters "
        f"{json.dumps(warm.counters)}; level widths {[l.n for l in warm.index.levels]}")
    wsnap = IndexSnapshot.build(warm.index, small, device=dev)
    first = [np.arange(BATCH)]
    (out,), (t_batch,) = serve(wsnap, shifted.rects, shifted.kw_bitmap, first)
    rows = np.flatnonzero(out["overflow"] == 0)
    if rows.size < N_ORACLE:
        raise AssertionError(f"only {rows.size} rebuilt-index queries without overflow")
    check_skr_oracle(execute_serial, warm.index, small, shifted.subset(first[0]), out, rows,
                     "warm-rebuilt index")
    log(f"warm-rebuilt index: a batch of {BATCH} in {t_batch:.6f} s, its {rows.size} queries "
        f"without overflow equal execute_serial")


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.baselines.conventional import build_str_rtree
    from repro_torch.core.query import SubscriptionOracle, execute_serial, knn_query
    from repro_torch.core.types import ids_to_bitmap
    from repro_torch.data.synth import make_dataset
    from repro_torch.data.workloads import make_update_stream, make_workload
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch.wisk_serve import serve_batch, serve_knn_batch
    from repro_torch.serve import subscribe as subscribe_mod
    from repro_torch.serve.delta import DeltaLog
    from repro_torch.serve.engine import retrieve, retrieve_knn
    from repro_torch.serve.plan import PlanCache
    from repro_torch.serve.snapshot import IndexSnapshot, to_device
    from repro_torch.serve.subscribe import SubscriptionIndex

    # the plain versions' matrix products in full f32 (TF32 would be what
    # the CDF comparison measured); cdf_mlp_ref also enforces it itself
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(DEVICE)
    card = gpu_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    with phase("kernel build"):
        _build.build_all()
    for src, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # ---------------------------------------------------- data and index
    with phase("data, index and snapshot"):
        t0 = time.perf_counter()
        ds = make_dataset(PROFILE, n=N_OBJECTS, seed=SEED)
        t1 = time.perf_counter()
        index = build_str_rtree(ds, leaf_size=LEAF_SIZE, fanout=FANOUT)
        t2 = time.perf_counter()
        snap = IndexSnapshot.build(index, ds, device=dev, dense=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    assert snap.has_narrow_planes, "a level overflowed NARROW_DICT_MAX"
    assert snap.has_compact_bank, "a leaf overflowed LEAF_DICT_MAX"
    log(f"dataset {PROFILE} n={ds.n} W={ds.words} vocab={ds.vocab_size}: {t1 - t0:.3f} s")
    log(f"str-rtree levels={[l.n for l in index.levels]}: {t2 - t1:.3f} s")
    log(f"snapshot (dense=True): {t3 - t2:.3f} s, {snap.nbytes()} B on the device, of which "
        f"{sum(m.numel() for m in snap.child_matrix)} B of dense child matrices; "
        f"OBJ={snap.obj_per_leaf} Wl={snap.n_compact_words} "
        f"dicts={[int(d.numel()) for d in snap.level_dict_x]}")
    wl = make_workload(ds, m=N_QUERIES, dist="MIX", seed=1)
    points = query_points(wl)
    bms = wl.kw_bitmap
    batches = [np.arange(i, i + BATCH) for i in range(0, N_QUERIES, BATCH)]
    n_leaf = index.levels[-1].n

    def cached(warm):
        cache = PlanCache()
        cache.widths = dict(warm.widths)
        return cache

    # ------------------------ warm-up passes, capturing kernel operands
    captured = {}

    def recorder(key, fn, size_arg, kw_keys=()):
        """Pass calls through to ``fn``, keeping the largest call's operands
        (the keyword arguments ``kw_keys`` appended to the positional ones;
        only calls that pass them all count)."""
        def rec(*args, **kw):
            prev = captured.get(key)
            given = all(kw.get(k) is not None for k in kw_keys)
            if given and (prev is None or args[size_arg].numel() > prev[size_arg].numel()):
                captured[key] = args + tuple(kw[k] for k in kw_keys)
            return fn(*args, **kw)
        return rec

    warm, warm_knn = PlanCache(), PlanCache()
    with phase("warm-up: SKR and kNN batches"), patched(
        ops,  # sized by the frontier (M, F) and top_leaf (M, T)
        frontier_level_narrow=recorder("frontier_level_narrow", ops.frontier_level_narrow, 4),
        fused_verify_leaf_words=recorder("fused", ops.fused_verify_leaf_words, 3),
        knn_level_dist_narrow=recorder("knn_level_dist_narrow", ops.knn_level_dist_narrow, 5),
    ):
        for b in batches:
            serve_batch(snap, wl.rects[b], bms[b], MAX_LEAVES, plan_cache=warm)
        for b in batches:
            serve_knn_batch(snap, points[b], bms[b], K, plan_cache=warm_knn)
    log(f"learned widths: SKR {sorted(warm.widths.items())}, "
        f"kNN {sorted(warm_knn.widths.items())}")

    # ------------------------------------------------------ SKR main path
    def serve_all(variant=None):
        cache = cached(warm)
        outs, times = [], []
        for b in batches:
            t = time.perf_counter()
            if variant is None:
                out = serve_batch(snap, wl.rects[b], bms[b], MAX_LEAVES, plan_cache=cache)
            else:
                out = retrieve(snap, wl.rects[b], bms[b], MAX_LEAVES,
                               plan_cache=cache, fused_variant=variant)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            outs.append(out)
        return outs, times

    def refuse(what):
        def fail(*a, **kw):
            raise AssertionError(f"the run called {what}, which it no longer needs")
        return fail

    # no per-slot planes on any descent: the range filters' gathered-plane
    # wrappers (the TPU kernels' operands) must not run
    no_slot_planes = dict(filter_frontier=refuse("filter_frontier"),
                          filter_frontier_narrow=refuse("filter_frontier_narrow"))
    # no fused SKR batch builds the compact verify's per-slot query words:
    # the kernel remaps them itself
    no_remap = dict(remap_query_words=refuse("remap_query_words"))

    def check_descent(counts, name, what):
        """The descent ran ``name`` once per level of every batch, and the
        other frontier filter never."""
        other = "frontier_level" if name == "frontier_level_narrow" else "frontier_level_narrow"
        if counts[name] != snap.n_levels * len(batches) or counts[other]:
            raise AssertionError(f"{what} did not launch {name} once per level: {counts}")

    plain_fused = lambda *a: ref.fused_verify_compact_ref(*a)  # noqa: E731
    plain_leaf = lambda *a, variant="auto", words=False: (  # noqa: E731
        ref.fused_verify_leaf_words_ref(*a, words=words))

    def check_remap(counts, name, what):
        """The fused verify ran its remapping instance ``name`` once a batch
        and the given-words instances never."""
        given = counts["fused_verify_compact_slot"] + counts["fused_verify_compact_tile"]
        if counts[name] != len(batches) or given:
            raise AssertionError(f"{what} did not launch {name} once a batch: {counts}")

    launches = {}
    with phase("SKR main path, plain rerun"):
        _build.reset_launch_counts()
        with patched(ops, **no_slot_planes, **no_remap):
            main_out, main_t = serve_all()
            main_counts = _build.launch_counts()
            log(f"SKR main path serve_batch x{len(batches)} (auto): batch s {main_t}, "
                f"launches {main_counts}; no per-slot plane gathered, remap_query_words "
                f"refused")
            _build.reset_launch_counts()
            vmem_out, vmem_t = serve_all("vmem")
            vmem_counts = _build.launch_counts()
        log(f"SKR main path retrieve(fused_variant='vmem') x{len(batches)}: batch s {vmem_t}, "
            f"launches {vmem_counts}")
        check_descent(main_counts, "frontier_level_narrow", "the SKR main path")
        check_descent(vmem_counts, "frontier_level_narrow", "the SKR vmem run")
        check_remap(main_counts, "fused_verify_remap_slot", "the SKR main path")
        check_remap(vmem_counts, "fused_verify_remap_tile", "the SKR vmem run")
        for key, counts in (("frontier_level_narrow", main_counts),
                            ("fused_verify_remap_slot", main_counts),
                            ("fused_verify_remap_tile", vmem_counts)):
            if counts[key] <= 0:
                raise AssertionError(f"the SKR main path never launched {key}")
            launches[key] = counts[key]

        _build.reset_launch_counts()
        with patched(ops, frontier_level_narrow=ref.frontier_level_narrow_ref,
                     fused_verify_leaf_words=plain_leaf):
            plain_out, plain_t = serve_all()
        if any(_build.launch_counts().values()):
            raise AssertionError("the plain run launched a kernel")
        log(f"SKR plain-version run: batch s {plain_t}")
        for run, outs in (("auto", main_out), ("vmem", vmem_out)):
            for bi, (got, want) in enumerate(zip(outs, plain_out)):
                assert_outputs_equal(got, want, f"SKR {run} batch {bi} vs the plain run")
        log("SKR main path equals the plain-version run on every key, dtype and shape")

    # ---------------------------------------------------------- host oracle
    with phase("SKR execute_serial oracle"):
        cat = {k: np.concatenate([o[k] for o in main_out]) for k in
               ("ids", "nodes_checked", "verified", "overflow", "counts")}
        ok = np.flatnonzero(cat["overflow"] == 0)[:N_ORACLE]
        if ok.size < N_ORACLE:
            raise AssertionError(f"only {ok.size} queries without overflow")
        oracle_st = check_skr_oracle(execute_serial, index, ds, wl, cat, ok, "SKR main path")
        oracle_ok = ok
        log(f"execute_serial oracle on {ok.size} queries with overflow == 0: equal; "
            f"queries with overflow: {int((cat['overflow'] > 0).sum())} of {N_QUERIES}, "
            f"results {int(cat['counts'].sum())}")

    # ------------------------------------------------------ kNN main path
    def serve_knn_all(k=K, knn_dtype="f32"):
        cache = cached(warm_knn)
        outs, times = [], []
        for b in batches:
            t = time.perf_counter()
            outs.append(serve_knn_batch(snap, points[b], bms[b], k, plan_cache=cache,
                                        knn_dtype=knn_dtype))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return outs, times

    with phase("kNN main path, plain rerun"):
        _build.reset_launch_counts()
        # no per-slot planes: the gathered-plane wrappers must not run
        with patched(ops, knn_frontier_dist_narrow=refuse("knn_frontier_dist_narrow"),
                     **no_slot_planes):
            knn_out, knn_t = serve_knn_all()
        knn_counts = _build.launch_counts()
        log(f"kNN main path serve_knn_batch(k={K}) x{len(batches)}: batch s {knn_t}, "
            f"launches {knn_counts}; no per-slot plane gathered")
        if knn_counts["knn_level_dist_narrow"] <= 0:
            raise AssertionError("the kNN main path never launched knn_level_dist_narrow")
        launches["knn_level_dist_narrow"] = knn_counts["knn_level_dist_narrow"]
        _build.reset_launch_counts()
        with patched(ops, knn_level_dist_narrow=ref.knn_level_dist_narrow_ref):
            knn_plain, knn_plain_t = serve_knn_all()
        if any(_build.launch_counts().values()):
            raise AssertionError("the kNN plain run launched a kernel")
        log(f"kNN plain-version run: batch s {knn_plain_t}")
        for bi, (got, want) in enumerate(zip(knn_out, knn_plain)):
            assert_outputs_equal(got, want, f"kNN batch {bi} vs the plain run")
        log("kNN main path equals the plain-version run on every key, dtype and shape")

    with phase("kNN knn_query oracle, k = 1 and 100, bf16"):
        kcat = {k: np.concatenate([o[k] for o in knn_out]) for k in
                ("ids", "dist2", "leaves_verified", "pruned", "verified")}
        check_knn_oracle(knn_query, index, ds, kcat, points, bms, range(N_ORACLE), K,
                         f"kNN k={K}")
        ratio = N_QUERIES * n_leaf / max(float(kcat["leaves_verified"].sum()), 1.0)
        if not ratio > 1.0:
            raise AssertionError(f"the bounded descent did not prune (ratio {ratio})")
        log(f"knn_query oracle on {N_ORACLE} queries at k={K}: ids and dist2 bit-equal; "
            f"pruning ratio {ratio:.3f} (m * n_leaf / leaves verified), mean leaves verified "
            f"{kcat['leaves_verified'].mean():.3f}, objects verified "
            f"{kcat['verified'].mean():.3f}, slots pruned {kcat['pruned'].mean():.3f}, "
            f"frontier widths {knn_out[0]['frontier_widths'].tolist()}")
        b0 = batches[0]
        for k in K_EDGES:
            t = time.perf_counter()
            out = serve_knn_batch(snap, points[b0], bms[b0], k, plan_cache=cached(warm_knn))
            torch.cuda.synchronize()
            t = time.perf_counter() - t
            check_knn_oracle(knn_query, index, ds, out, points[b0], bms[b0], range(N_ORACLE), k,
                             f"kNN k={k}")
            log(f"k={k}: one batch {t:.6f} s, ids and dist2 bit-equal to knn_query on "
                f"{N_ORACLE} queries, frontier widths {out['frontier_widths'].tolist()}")
        t = time.perf_counter()
        bf = serve_knn_batch(snap, points[b0], bms[b0], K, plan_cache=cached(warm_knn),
                             knn_dtype="bf16")
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        for key in ("ids", "dist2"):
            if not np.array_equal(bf[key], knn_out[0][key]):
                raise AssertionError(f"knn_dtype='bf16' {key} differs from f32")
        log(f"knn_dtype='bf16' batch {t:.6f} s: ids and dist2 equal to f32 "
            f"(knn_dtype_retried={bf['knn_dtype_retried']})")

    # ------------------------------------------------------- f32 descent
    with phase("f32 descent: quantized=False and stripped snapshot"):
        _build.reset_launch_counts()
        with patched(ops, frontier_level=recorder("frontier_level/f32", ops.frontier_level, 4),
                     **no_slot_planes):
            cache = cached(warm)
            f32_t = []
            for bi, b in enumerate(batches):
                t = time.perf_counter()
                out = retrieve(snap, wl.rects[b], bms[b], MAX_LEAVES, plan_cache=cache,
                               quantized=False)
                torch.cuda.synchronize()
                f32_t.append(time.perf_counter() - t)
                assert_outputs_equal(out, main_out[bi], f"SKR quantized=False batch {bi}")
        counts = _build.launch_counts()
        log(f"SKR quantized=False x{len(batches)}: batch s {f32_t}, launches {counts}")
        check_descent(counts, "frontier_level", "the SKR f32 descent")
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with patched(ops, knn_level_dist=recorder("knn_level_dist", ops.knn_level_dist, 5)):
            t = time.perf_counter()
            out = retrieve_knn(snap, points[b0], bms[b0], K, plan_cache=cached(warm_knn),
                               quantized=False)
            torch.cuda.synchronize()
            t = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - mem0
        assert_outputs_equal(out, knn_out[0], "kNN quantized=False batch 0")
        counts = _build.launch_counts()
        fr = captured["knn_level_dist"][5]
        plane = fr.numel() * snap.level_bms[-1].shape[1] * 4
        log(f"kNN quantized=False: one batch {t:.6f} s, peak device memory above the start "
            f"{peak} B (an (M, F, W) word plane at the widest level would be {plane} B), "
            f"launches {counts}")
        if counts["knn_level_dist"] <= 0 or counts["knn_level_dist_narrow"] != 0:
            raise AssertionError("the kNN f32 descent did not run on knn_level_dist alone")
        if peak >= plane:
            raise AssertionError("the kNN f32 descent allocated an (M, F, W) word plane")
        launches["knn_level_dist"] = counts["knn_level_dist"]

        stripped = dataclasses.replace(snap, level_mbr_codes=[], level_dict_x=[],
                                       level_dict_y=[])
        assert not stripped.has_narrow_planes
        out = retrieve(stripped, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=cached(warm))
        assert_outputs_equal(out, main_out[0], "SKR on the stripped snapshot")
        out = retrieve_knn(stripped, points[b0], bms[b0], K, plan_cache=cached(warm_knn))
        assert_outputs_equal(out, knn_out[0], "kNN on the stripped snapshot")
        log("quantized=False and stripped-snapshot runs equal the default runs on every key")

    # ------------------------------------------------------- verify knobs
    # one batch per knob, equal to the default run; each kernel's operands
    # captured at the shapes the knob gives it
    knob_launches = {}
    no_cbank = dataclasses.replace(snap, leaf_terms=None, leaf_obj_cbm=None, leaf_obj_sig=None)
    knobs = [  # (label, snapshot, retrieve knobs, kernels the run must launch)
        ("fused=False", snap, dict(fused=False), ("skr_verify_compact",)),
        ("compact=False", snap, dict(compact=False), ("fused_verify_slot",)),
        ("compact=False, fused_variant='vmem'", snap, dict(compact=False, fused_variant="vmem"),
         ("fused_verify_tile",)),
        ("fused=False, compact=False", snap, dict(fused=False, compact=False), ("skr_verify",)),
        ("no compact bank", no_cbank, {}, ("fused_verify_slot",)),
    ]
    with phase("verify knobs"), patched(
        ops,  # sized by top_leaf (M, T) and cand_x (M, C)
        fused_gather_verify=recorder("fused_wide", ops.fused_gather_verify, 2, ("q_words",)),
        verify_candidates_counted=recorder("skr_verify/knob", ops.verify_candidates_counted, 2),
        verify_candidates_compact_counted=recorder("skr_verify_compact/knob",
                                                   ops.verify_candidates_compact_counted, 3),
    ):
        for label, snap_k, kw, kernels in knobs:
            _build.reset_launch_counts()
            t = time.perf_counter()
            out = retrieve(snap_k, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=cached(warm), **kw)
            torch.cuda.synchronize()
            t = time.perf_counter() - t
            counts = _build.launch_counts()
            assert_outputs_equal(out, main_out[0], f"SKR {label}")
            for name in kernels:
                if counts[name] <= 0:
                    raise AssertionError(f"SKR {label} never launched {name}")
                knob_launches.setdefault(name, counts[name])
            log(f"SKR {label}: one batch {t:.6f} s, equal to the default run on every key; "
                f"launches {counts}")
    del no_cbank

    # -------------------------------------------------------- live updates
    leaf_mbrs = index.levels[-1].mbrs
    leaf_terms = snap.leaf_terms.cpu().numpy()
    plain_ops = dict(
        frontier_level=ref.frontier_level_ref,
        fused_verify_leaf_words=plain_leaf,
        verify_slots=ref.skr_verify_slots_ref,
        verify_slots_compact=ref.skr_verify_slots_compact_ref,
        knn_level_dist=ref.knn_level_dist_ref,
    )
    slot_kernels = ("skr_verify_slots", "skr_verify_slots_compact")
    delta_launches = {}
    delta_bufs = {}
    delta_caches = {}  # label -> the SKR plan cache learned with the log's delta
    delta_skr = {}  # label -> the SKR batches served with the log's delta

    def live_updates(label, own_leaf_terms, jitter, seed, verify_kernel, capture):
        """One DeltaLog: N_INSERT inserts in batches, N_DELETE deletes, the
        SKR batches and one kNN batch against their plain reruns and the
        host oracles over a cold index of the merged data."""
        rng = np.random.default_rng(seed)
        leaf_vocab = (leaf_mbrs, leaf_terms) if own_leaf_terms else ()
        dlog = DeltaLog(index, ds, snap)
        t_ins, new_ids = [], []
        n_batches = N_INSERT // INSERT_BATCH
        probe = None
        for i in range(n_batches):
            locs, kw = make_update_stream(ds, INSERT_BATCH, rng, jitter, *leaf_vocab)
            if i == n_batches - 1:  # deletes, then a buffer handed out before the last insert
                dels = np.concatenate([
                    rng.choice(ds.n, N_DELETE - N_DELETE_BUFFERED, replace=False),
                    rng.choice(np.concatenate(new_ids), N_DELETE_BUFFERED, replace=False)])
                if dlog.delete(dels) != N_DELETE:
                    raise AssertionError(f"log {label}: not every delete took")
                old = dlog.buffer
                probe = serve_batch(snap, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=PlanCache(),
                                    delta=old)
            t = time.perf_counter()
            new_ids.append(dlog.insert(locs, kw))
            torch.cuda.synchronize()
            t_ins.append(time.perf_counter() - t)
        buf = dlog.buffer
        again = serve_batch(snap, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=PlanCache(),
                            delta=old)
        assert_outputs_equal(again, probe, f"log {label}: the buffer taken before the last insert")
        if dlog.compact_ok != own_leaf_terms:
            raise AssertionError(f"log {label}: compact_ok is {dlog.compact_ok}")
        if buf.n_buffered() != N_INSERT - N_DELETE_BUFFERED or buf.n_deleted() != \
                N_DELETE - N_DELETE_BUFFERED:
            raise AssertionError(f"log {label}: buffered/deleted counts are off")
        log(f"log {label}: {N_INSERT} inserts in batches of {INSERT_BATCH}, host s per batch "
            f"{t_ins} (mean {1e3 * np.mean(t_ins):.3f} ms per {INSERT_BATCH}); {N_DELETE} deletes "
            f"({N_DELETE_BUFFERED} buffered); slots_per_leaf={buf.slots_per_leaf} "
            f"compact_ok={dlog.compact_ok}; delta on the device {buf.nbytes()} B; the buffer "
            f"taken before the last insert still gives its earlier answer")

        skr_cache, knn_cache = PlanCache(), PlanCache()

        def serve_skr(cache):
            outs, times = [], []
            for b in batches:
                t = time.perf_counter()
                outs.append(serve_batch(snap, wl.rects[b], bms[b], MAX_LEAVES, plan_cache=cache,
                                        delta=buf))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            return outs, times

        def serve_knn(cache):
            t = time.perf_counter()
            out = serve_knn_batch(snap, points[b0], bms[b0], K, plan_cache=cache, delta=buf)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        serve_skr(skr_cache)  # warm-up: learns the widened descent's widths
        serve_knn(knn_cache)
        _build.reset_launch_counts()
        with patched(ops, frontier_level=recorder(f"frontier_level/log {label}",
                                                  ops.frontier_level, 4),
                     **{capture[0]: recorder(capture[1], getattr(ops, capture[0]), capture[2])},
                     **no_slot_planes, **no_remap):
            skr_out, skr_t = serve_skr(cached(skr_cache))
        skr_counts = _build.launch_counts()
        _build.reset_launch_counts()
        knn_d, knn_dt = serve_knn(cached(knn_cache))
        knn_counts = _build.launch_counts()
        log(f"log {label} SKR serve_batch(delta) x{len(batches)}: batch s {skr_t}, launches "
            f"{skr_counts}; remap_query_words refused")
        log(f"log {label} kNN serve_knn_batch(k={K}, delta): one batch {knn_dt:.6f} s, launches "
            f"{knn_counts}")
        check_descent(skr_counts, "frontier_level", f"log {label} SKR")
        check_remap(skr_counts, "fused_verify_remap_slot", f"log {label} SKR")
        # the insert slots: the slot entry once a batch, on the delta's own
        # buffers, and no gathered entry
        others = [n for n in (*slot_kernels, "skr_verify", "skr_verify_compact")
                  if n != verify_kernel and skr_counts[n]]
        if skr_counts[verify_kernel] != len(batches) or others:
            raise AssertionError(f"log {label}: SKR did not launch {verify_kernel} once a batch "
                                 f"and no other verify entry: {skr_counts}")
        if knn_counts["knn_level_dist_narrow"]:
            raise AssertionError(f"log {label}: a delta descent ran on the narrow planes")
        if knn_counts["knn_level_dist"] <= 0:
            raise AssertionError(f"log {label}: kNN never launched knn_level_dist")
        delta_launches[verify_kernel] = skr_counts[verify_kernel]
        delta_launches["frontier_level"] = skr_counts["frontier_level"]  # log B's is the row's
        _build.reset_launch_counts()
        with patched(ops, **plain_ops):
            plain_skr, _ = serve_skr(cached(skr_cache))
            plain_knn, _ = serve_knn(cached(knn_cache))
        if any(_build.launch_counts().values()):
            raise AssertionError(f"log {label}: the plain run launched a kernel")
        for bi, (got, want) in enumerate(zip(skr_out, plain_skr)):
            assert_outputs_equal(got, want, f"log {label} SKR batch {bi} vs the plain run")
        assert_outputs_equal(knn_d, plain_knn, f"log {label} kNN vs the plain run")

        merged = dlog.merged_dataset()
        cold = build_str_rtree(merged, leaf_size=LEAF_SIZE, fanout=FANOUT)
        cat = {k: np.concatenate([o[k] for o in skr_out]) for k in ("ids", "overflow")}
        ok = np.flatnonzero(cat["overflow"] == 0)[:N_ORACLE]
        if ok.size < N_ORACLE:
            raise AssertionError(f"log {label}: only {ok.size} queries without overflow")
        st = execute_serial(cold, merged, wl.subset(ok))
        for j, q in enumerate(ok):
            row = cat["ids"][q]
            if not np.array_equal(np.sort(row[row >= 0]), np.sort(st.results[j])):
                raise AssertionError(f"log {label} query {q}: ids differ from execute_serial")
        check_knn_oracle(knn_query, cold, merged, knn_d, points[b0], bms[b0], range(N_ORACLE), K,
                         f"log {label} kNN")
        log(f"log {label}: every key equals the plain-version run; SKR ids equal execute_serial "
            f"and kNN ids and dist2 equal knn_query on {N_ORACLE} queries each, over a cold "
            f"STR index of the {merged.n} merged objects")
        delta_bufs[label] = buf
        delta_caches[label] = skr_cache
        delta_skr[label] = skr_out

    with phase("live updates"):
        live_updates("A", True, 1e-3, 21, "skr_verify_slots_compact",
                     ("verify_slots_compact", "skr_verify_slots_compact/delta", 3))
        live_updates("B", False, 0.05, 22, "skr_verify_slots",
                     ("verify_slots", "skr_verify_slots/delta", 2))

    with phase("delta SKR batch memory"):
        # log B's warm delta SKR batch, peak device memory above its start
        # against one (M, T*B, W) int32 plane of its insert slots: the plane
        # the engine gathered before row 10 read the delta's buffers
        slot_args = captured["skr_verify_slots/delta"]
        M, T = slot_args[2].shape
        _, B, W = slot_args[6].shape
        plane = M * T * B * W * 4
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = serve_batch(snap, wl.rects[b0], bms[b0], MAX_LEAVES,
                          plan_cache=cached(delta_caches["B"]), delta=delta_bufs["B"])
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - mem0
        assert_outputs_equal(out, delta_skr["B"][0], "log B's delta SKR batch 0 again")
        log(f"log B's warm delta SKR batch: {t:.6f} s, peak device memory above its start "
            f"{peak} B; one (M, T*B, W) = ({M}, {T}*{B}, {W}) int32 insert-slot plane {plane} B")
        if peak >= plane:
            raise AssertionError("log B's delta SKR batch allocated an insert-slot plane's bytes")

    # ------------------------------------------------------ dense A/B scan
    def sorted_sets(out):
        return [np.sort(row[row >= 0]) for row in out["ids"]]

    def same_sets(got, want, what):
        if not np.array_equal(got["overflow"], want["overflow"]):
            raise AssertionError(f"{what}: overflow differs from the frontier run")
        for q, (a, b) in enumerate(zip(sorted_sets(got), sorted_sets(want))):
            if not np.array_equal(a, b):
                raise AssertionError(f"{what} query {q}: result set differs from the frontier run")

    plain_dense_ops = dict(
        filter_pairs=ref.skr_filter_ref,
        fused_verify_leaf_words=plain_leaf,
        verify_slots=ref.skr_verify_slots_ref,
        verify_slots_compact=ref.skr_verify_slots_compact_ref,
    )
    dense_levels = []  # the first batch's filter_pairs operands, one per level
    record_filter = recorder("skr_filter", ops.filter_pairs, 2)

    def record_levels(*a, **kw):
        if len(dense_levels) < snap.n_levels:
            dense_levels.append(a)
        return record_filter(*a, **kw)

    with phase("dense A/B scan"):
        _build.reset_launch_counts()
        dense_out, dense_t = [], []
        with patched(ops, filter_pairs=record_levels, **no_remap):
            for b in batches:
                t = time.perf_counter()
                dense_out.append(serve_batch(snap, wl.rects[b], bms[b], MAX_LEAVES, mode="dense"))
                torch.cuda.synchronize()
                dense_t.append(time.perf_counter() - t)
        counts = _build.launch_counts()
        if counts["skr_filter"] != snap.n_levels * len(batches) or counts["frontier_level_narrow"]:
            raise AssertionError(f"the dense scan did not run skr_filter once per level: {counts}")
        launches["skr_filter"] = counts["skr_filter"]
        log(f"dense serve_batch(mode='dense') x{len(batches)}: batch s {dense_t}, skr_filter "
            f"launches per batch {counts['skr_filter'] // len(batches)}, launches {counts}")
        # every level's launch of a batch, timed alone at its operands: the
        # kernel's device time and the wrapper's time per call back to back
        lvl = [kernel_ms(lambda a=a: ops.filter_pairs(*a)) for a in dense_levels]
        lvl_bound = [bound_ms(*filter_bound(a))[0] for a in dense_levels]
        log(f"skr_filter per level of dense batch 0 at K = "
            f"{[int(a[2].shape[0]) for a in dense_levels]}: kernel {[note for _, note in lvl]}; sum per batch {sum(t for t, _ in lvl):.6f} ms; "
            f"bound ms {[round(t, 6) for t in lvl_bound]}, sum {sum(lvl_bound):.6f} ms")
        _build.reset_launch_counts()
        with patched(ops, **plain_dense_ops):
            dense_plain = [serve_batch(snap, wl.rects[b], bms[b], MAX_LEAVES, mode="dense")
                           for b in batches]
        if any(_build.launch_counts().values()):
            raise AssertionError("the dense plain run launched a kernel")
        for bi, (got, want) in enumerate(zip(dense_out, dense_plain)):
            assert_outputs_equal(got, want, f"dense batch {bi} vs the plain run")
            same_sets(got, main_out[bi], f"dense batch {bi}")
            if (got["nodes_scanned"] < main_out[bi]["nodes_scanned"]).any():
                raise AssertionError(f"dense batch {bi}: nodes_scanned below the frontier's")
        dcat = np.concatenate([o["ids"] for o in dense_out])
        for j, q in enumerate(oracle_ok):
            row = dcat[q]
            if not np.array_equal(np.sort(row[row >= 0]), np.sort(oracle_st.results[j])):
                raise AssertionError(f"dense query {q}: ids differ from execute_serial")
        t = time.perf_counter()
        dense_delta = serve_batch(snap, wl.rects[b0], bms[b0], MAX_LEAVES, mode="dense",
                                  delta=delta_bufs["A"])
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        with patched(ops, **plain_dense_ops):
            want = serve_batch(snap, wl.rects[b0], bms[b0], MAX_LEAVES, mode="dense",
                               delta=delta_bufs["A"])
        assert_outputs_equal(dense_delta, want, "dense batch with log A's delta vs the plain run")
        same_sets(dense_delta, delta_skr["A"][0], "dense batch with log A's delta")
        log(f"dense scan: every key equals the plain-version run; overflow and result sets equal "
            f"the frontier run's; nodes_scanned {int(dense_out[0]['nodes_scanned'][0])} vs the "
            f"frontier's {int(main_out[0]['nodes_scanned'].max())} at most; ids equal "
            f"execute_serial on {oracle_ok.size} queries; with log A's delta one batch {t:.6f} s, "
            f"equal to its plain rerun and to the frontier's result sets")

    # ------------------------------------------------ standing subscriptions
    class StepClock:
        """Host time of ``match_arrivals``' steps: while ``on``, each
        wrapped function's time (after a device sync) adds to its step; a
        wrapped call inside another counts only in the outer one."""

        def __init__(self):
            self.on, self.busy, self.acc = False, False, {}

        def wrap(self, step, fn):
            def timed(*a, **kw):
                if not self.on or self.busy:
                    return fn(*a, **kw)
                self.busy = True
                t = time.perf_counter()
                try:
                    out = fn(*a, **kw)
                    torch.cuda.synchronize()
                finally:
                    self.busy = False
                self.acc[step] = self.acc.get(step, 0.0) + time.perf_counter() - t
                return out
            return timed

    def subscription_stream(arrivals=None, dlog=None, twin=None, clock=None):
        """One run of the subscription schedule. With ``dlog`` the arrivals
        are log A's insert batches, inserted into ``dlog`` and matched in
        the same step (``twin``, if given, pumps the log after each batch);
        else the recorded ``arrivals`` are replayed. Returns the index, the
        arrival batches, the unsubscribed ids and per batch of
        ``match_arrivals``: host seconds, peak device memory above its
        start, notifications queued and (with ``clock``) host seconds by
        step."""
        idx = SubscriptionIndex(ds.vocab_size, device=dev)
        indexes = [idx] + ([twin] if twin is not None else [])
        for i in indexes:
            for r, kw in zip(subs_wl.rects, subs_wl.kw_ids):
                i.subscribe(r, kw)
        rng = np.random.default_rng(21)
        leaf_vocab = (leaf_mbrs, leaf_terms)
        batches_in, gone = [], None
        per = dict(t=[], peak=[], queued=[], steps=[])
        for bi in range(N_INSERT // INSERT_BATCH):
            if dlog is not None:
                locs, kw = make_update_stream(ds, INSERT_BATCH, rng, 1e-3, *leaf_vocab)
                ids = dlog.insert(locs, kw)
                batches_in.append((ids, locs, kw))
            else:
                ids, locs, kw = arrivals[bi]
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if clock is not None:
                clock.on, clock.acc = True, {}
            t = time.perf_counter()
            per["queued"].append(idx.match_arrivals(ids, locs, kw_ids=kw))
            torch.cuda.synchronize()
            per["t"].append(time.perf_counter() - t)
            per["peak"].append(torch.cuda.max_memory_allocated() - mem0)
            if clock is not None:
                clock.on = False
                per["steps"].append(clock.acc)
            if twin is not None:
                twin.pump(dlog)
            if bi == 4:  # churn: 10,000 leave, 10,000 join into their slots
                gone = np.random.default_rng(23).choice(N_SUBS, N_SUB_CHURN, replace=False)
                for i in indexes:
                    for sid in gone:
                        i.unsubscribe(int(sid))
                    for r, kw in zip(churn_wl.rects, churn_wl.kw_ids):
                        i.subscribe(r, kw)
        return idx, batches_in, gone, per

    def plain_pairs(o_pts, o_bm, s_rects, s_bm, s_sig):
        """``match_subscription_pairs`` on the plain version, through the
        same capacity retry."""
        args = (o_pts, o_bm, s_rects, s_bm, s_sig)
        pairs, count = ref.sub_match_pairs_ref(*args, ops.SUB_PAIRS_CAPACITY)
        n = int(count)
        if n > ops.SUB_PAIRS_CAPACITY:
            pairs, _ = ref.sub_match_pairs_ref(*args, n)
        return pairs[:n]

    def canon(pairs, S):
        """Match pairs in (object, slot) order."""
        return pairs[torch.argsort(pairs[:, 0].long() * S + pairs[:, 1].long())]

    # the stream runs neither the matrix entries nor host packing
    no_matrix = dict(sub_match=refuse("sub_match"), match_subscriptions=refuse(
        "match_subscriptions"), pack_query_words=refuse("pack_query_words"))
    with phase("standing subscriptions"):
        t = time.perf_counter()
        subs_wl = make_workload(ds, m=N_SUBS, dist="MIX", seed=2)
        churn_wl = make_workload(ds, m=N_SUB_CHURN, dist="MIX", seed=3)
        log(f"subscription rectangles and keywords (MIX workloads of {N_SUBS} and "
            f"{N_SUB_CHURN}): {time.perf_counter() - t:.3f} s")
        dlog = DeltaLog(index, ds, snap)
        twin = SubscriptionIndex(ds.vocab_size, device=dev)
        clock = StepClock()
        compile_block = clock.wrap("block compile", SubscriptionIndex.block)
        pair_calls = []
        record_pairs = recorder("sub_match_pairs", clock.wrap(
            "kernel and count readback", ops.match_subscription_pairs), 1)
        _build.reset_launch_counts()
        with patched(ops, match_subscription_pairs=lambda *a: pair_calls.append(1) or record_pairs(*a),
                     **no_matrix), \
                patched(subscribe_mod, ids_to_bitmap=clock.wrap("bitmaps", subscribe_mod.ids_to_bitmap),
                        to_device=clock.wrap("upload", subscribe_mod.to_device),
                        canonical_pairs=clock.wrap("sort and copy", subscribe_mod.canonical_pairs)), \
                patched(SubscriptionIndex, block=lambda self: (
                    compile_block(self) if self._block is None else self._block)):
            sub_idx, arrivals, gone, per = subscription_stream(dlog=dlog, twin=twin, clock=clock)
        counts = _build.launch_counts()
        n_batches = N_INSERT // INSERT_BATCH
        # each batch: one match by match_arrivals, one by the twin's pump
        if counts["sub_match_pairs"] < 2 * n_batches or counts["sub_match"]:
            raise AssertionError(f"the stream did not launch sub_match_pairs for every match and "
                                 f"the matrix instance never: {counts}")
        launches["sub_match_pairs"] = counts["sub_match_pairs"]
        retries = counts["sub_match_pairs"] - len(pair_calls)
        # peak device memory a match took: above the batch's start, less the
        # block compiled in the batch (the first, and the first after the churn)
        plane = INSERT_BATCH * sub_idx.n_slots  # one (N, S) int8 match matrix
        match_peak = [p - sub_idx.block().nbytes() * ("block compile" in d)
                      for p, d in zip(per["peak"], per["steps"])]
        if max(match_peak) >= plane:
            raise AssertionError(f"a match_arrivals batch allocated an (N, S) matrix's bytes: "
                                 f"{per['peak']}")
        if sub_idx.n_live != N_SUBS or sub_idx.n_slots != twin.n_slots:
            raise AssertionError("the block's live or slot count is off after the churn")
        if sub_idx.pump(dlog) != 0:
            raise AssertionError("pump after match_arrivals queued notifications")
        stream = sub_idx.drain()
        if not np.array_equal(stream, twin.drain()):
            raise AssertionError("the pump-only twin drained another stream")
        if sub_idx.drain().shape != (0, 2):
            raise AssertionError("a second drain was not empty")
        blk = sub_idx.block()
        t_match = per["t"]
        log(f"subscriptions: {N_SUBS} in {sub_idx.n_slots} slots, block {blk.nbytes()} B on the "
            f"device; {N_INSERT} arrivals in batches of {INSERT_BATCH}: match_arrivals host ms per "
            f"batch {[round(1e3 * t, 3) for t in t_match]} (mean {1e3 * np.mean(t_match):.3f}); "
            f"{stream.shape[0]} notifications, per batch {per['queued']}; sub_match_pairs launches "
            f"{counts['sub_match_pairs']} for {len(pair_calls)} matches (both indexes), retries "
            f"{retries} at capacity {ops.SUB_PAIRS_CAPACITY}; sub_match (the matrix) 0, "
            f"pack_query_words and the matrix entries refused; peak device memory above the start "
            f"per batch {per['peak']} B, less a block compiled in the batch {match_peak} B, below "
            f"one (N, S) int8 matrix ({plane} B); pump afterwards "
            f"queued nothing; the pump-only twin drained the same stream")
        steps = sorted({k for d in per["steps"] for k in d})
        for bi, (d, t) in enumerate(zip(per["steps"], t_match)):
            rest = t - sum(d.values())
            log(f"  match_arrivals batch {bi} host ms by step (each after a device sync): "
                + ", ".join(f"{k} {1e3 * d.get(k, 0.0):.3f}" for k in steps)
                + f", queue and the rest {1e3 * rest:.3f}")
        steady = [bi for bi, d in enumerate(per["steps"]) if "block compile" not in d]
        mean = {k: 1e3 * np.mean([per["steps"][bi].get(k, 0.0) for bi in steady]) for k in steps}
        log(f"  mean over the {len(steady)} batches with no block compile: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in mean.items())
            + f", total {1e3 * np.mean([t_match[bi] for bi in steady]):.3f} ms")
        _build.reset_launch_counts()
        with patched(ops, match_subscription_pairs=plain_pairs):
            plain_idx, _, _, _ = subscription_stream(arrivals=arrivals)
        if any(_build.launch_counts().values()):
            raise AssertionError("the plain subscription run launched a kernel")
        if not np.array_equal(plain_idx.drain(), stream):
            raise AssertionError("the stream differs from the plain-version run")
        del plain_idx, twin
        # the oracle replay on a seeded sample: half of it among the
        # subscriptions that were notified, half uniform over all of them
        rng = np.random.default_rng(29)
        notified = np.unique(stream[:, 1])
        half = min(N_SUB_SAMPLE // 2, notified.size)
        sample = np.union1d(rng.choice(notified, half, replace=False),
                            rng.choice(N_SUBS + N_SUB_CHURN, N_SUB_SAMPLE - half, replace=False))
        rects = np.concatenate([subs_wl.rects, churn_wl.rects])
        kws = np.concatenate([subs_wl.kw_ids, churn_wl.kw_ids])
        oracle, to_oracle = SubscriptionOracle(), {}
        gone_set = set(int(g) for g in gone)
        for sid in sample[sample < N_SUBS]:
            to_oracle[int(sid)] = oracle.subscribe(rects[sid], kws[sid])
        for bi, (ids, locs, kw) in enumerate(arrivals):
            oracle.arrive(ids, locs, kw)
            if bi == 4:
                for sid in sorted(gone_set & set(to_oracle)):
                    oracle.unsubscribe(to_oracle[sid])
                for sid in sample[sample >= N_SUBS]:
                    to_oracle[int(sid)] = oracle.subscribe(rects[sid], kws[sid])
        keep = np.isin(stream[:, 1], sample)
        mapped = np.stack([stream[keep, 0], [to_oracle[int(s)] for s in stream[keep, 1]]], 1)
        want = oracle.drain()
        if not np.array_equal(mapped.reshape(-1, 2), want):
            raise AssertionError("the sampled stream differs from SubscriptionOracle's replay")
        log(f"subscriptions: every notification equals the plain-version run pair for pair; on "
            f"{sample.size} sampled subscriptions ({half} of them notified) the {want.shape[0]} "
            f"notifications equal SubscriptionOracle's replay")
        # the matrix entry (match_subscriptions, host-packed words) on the
        # first arrival batch against the final block: its launch is row
        # 11's matrix instance, and its nonzero entries equal the pairs
        ids0, locs0, kw0 = arrivals[0]
        obm0 = ids_to_bitmap(np.asarray(kw0, np.int32).reshape(len(ids0), -1), ds.vocab_size)
        _build.reset_launch_counts()
        with patched(ops, sub_match=recorder("sub_match", ops.sub_match, 5)):
            mat = ops.match_subscriptions(locs0, obm0, blk.rects, blk.bm, blk.sig[:, 0])
            torch.cuda.synchronize()
        launches["sub_match"] = _build.launch_counts()["sub_match"]
        if launches["sub_match"] != 1:
            raise AssertionError("match_subscriptions did not launch sub_match once")
        pairs0 = ops.match_subscription_pairs(
            to_device(np.asarray(locs0, np.float32), dev), to_device(obm0, dev), blk.rects, blk.bm,
            blk.sig[:, 0])
        if not torch.equal(canon(pairs0, blk.n_slots), torch.nonzero(mat).to(torch.int32)):
            raise AssertionError("the pairs differ from the match matrix's nonzero entries")
        log(f"match_subscriptions (the matrix instance) on arrival batch 0 against the final "
            f"block: one launch, {int(mat.sum())} matches, equal to the pairs instance's")
        del dlog, blk, mat, pairs0

    # -------------------------------------------------------- the CDF bank
    with phase("CDF bank"):
        kw_counts = np.bincount(ds.kw_ids[ds.kw_ids >= 0], minlength=ds.vocab_size)
        n_high = int(((kw_counts / ds.n >= CDF_HIGH_FRAC) & (kw_counts >= 4)).sum())
        gen = torch.Generator().manual_seed(SEED)
        x_all = torch.from_numpy(np.ascontiguousarray(ds.locs[:, 0])).to(dev)
        cdf_args = cdf_bank(dev, 2 * n_high, CDF_HIDDEN, gen, x=x_all)
        _build.reset_launch_counts()
        t = time.perf_counter()
        cdf_out = ops.cdf_bank_forward(*cdf_args)
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        launches["cdf_mlp_bank"] = _build.launch_counts()["cdf_mlp_bank"]
        if launches["cdf_mlp_bank"] != 1:
            raise AssertionError("cdf_bank_forward did not launch cdf_mlp_bank once")
        err = max_abs_err(cdf_out, ref.cdf_mlp_ref(*cdf_args))
        if not err <= CDF_ATOL or not torch.isfinite(cdf_out).all():
            raise AssertionError(f"the CDF bank is off its plain version by {err}")
        captured["cdf_mlp_bank"] = cdf_args
        log(f"CDF bank: {n_high} keywords on at least {100 * CDF_HIGH_FRAC} % of the objects, "
            f"B={2 * n_high} MLPs of H={CDF_HIDDEN} at N={ds.n} points: {t:.6f} s, output "
            f"{tuple(cdf_out.shape)}, max abs err vs the chunked plain version {err:.3e} "
            f"(atol {CDF_ATOL})")
        del cdf_out
        # the edges: CDF_EDGE_X over objects' x coordinates, banks of B off
        # the kernel's 8-model tile, H = 32 and H = 4; a NaN point is NaN in
        # every column, and no finite one anywhere
        for B, H, n in ((2 * n_high + 1, 32, 100_000), (13, 4, 4099)):
            edge_args = cdf_bank(dev, B, H, gen, x=x_all[:n], edges=True)
            got = ops.cdf_bank_forward(*edge_args)
            torch.cuda.synchronize()
            plain = ref.cdf_mlp_ref(*edge_args)
            x_e = edge_args[1]
            assert_same(got, plain, f"the CDF bank at edge points, B={B} H={H}", CDF_ATOL)
            if not torch.isnan(got[torch.isnan(x_e)]).all() or torch.isnan(
                    got[torch.isfinite(x_e)]).any():
                raise AssertionError(f"the CDF bank's NaNs at B={B} H={H} are not the points'")
            log(f"CDF bank at B={B} H={H}, N={n} objects' x with {len(CDF_EDGE_X)} edge points "
                f"(NaN, +-inf, +-0, far): within atol {CDF_ATOL} of the plain version, max abs "
                f"err {max_abs_err(got, plain):.3e}, NaN where it is NaN")
        del got, plain, edge_args

    # ------------------------------------------------------- kernel phases
    rows = []
    csrc = "src/repro_torch/kernels/csrc/"
    # rows 2 and 3: the remapping instances at the main path's operands,
    # checked with words=False (as the engine runs them; the row's time) and
    # words=True; ragged: Wl of 1, 2 and 8, W of 1 and 3, OBJ of 1 and 37,
    # dirty leaf ids, leaf_ok = 0 rows, a query that meets no dictionary,
    # entries past 32*W, all -1 dictionaries
    fu_args = captured["fused"]
    fu_cases = [fu_args + (False,), fu_args + (True,)]
    remap_ragged = [ragged_fused(dev, W=3), ragged_fused(dev, M=1, T=1, K=1, OBJ=1, Wl=1, W=1,
                                                          seed=3),
                    ragged_fused(dev, M=9, T=4, K=6, OBJ=1, Wl=8, W=1, seed=4),
                    ragged_fused(dev, M=7, T=3, K=5, OBJ=37, Wl=8, W=3, seed=5),
                    ragged_fused(dev, M=6, T=6, K=4, OBJ=16, Wl=1, W=3, seed=6)]
    fused_ragged = [ragged_fused(dev), ragged_fused(dev, M=1, T=1, K=1, OBJ=1, Wl=1, seed=3)]

    def remap_entry(variant):
        return lambda *a: ops.fused_verify_leaf_words(*a[:10], variant=variant, words=a[10])

    def remap_plain(*a):
        return ref.fused_verify_leaf_words_ref(*a[:10], words=a[10])

    remap_bound = lambda a: fused_remap_bound(a, ref.remap_query_words_ref)  # noqa: E731

    def slot_phase(name, replaces, cases, kernel, plain, narrow):
        # dirty ids, a padding row, a query with no nonzero word and one
        # whose rectangle meets nothing, sizes off every block; N = W = 1
        # (with one-entry dictionaries); W = 64 with sparse queries; W past
        # one compaction round with terms on both sides of its edge; an
        # all-padding frontier
        d = lambda n: n if narrow else None  # noqa: E731
        ragged = [ragged_frontier_level(dev, ops, D=d(61)),
                  ragged_frontier_level(dev, ops, M=1, F=1, N=1, W=1, D=d(1), seed=32),
                  ragged_frontier_level(dev, ops, M=9, F=300, N=200, W=64, sparse=True,
                                        D=d(150), seed=33),
                  ragged_frontier_level(dev, ops, M=5, F=40, N=30, W=2100, D=d(40), seed=34)]
        pad = ragged[0]
        ragged.append(pad[:4] + (torch.full_like(pad[4], -1),) + pad[5:])
        return (name, csrc + "frontier.cu", replaces, cases, ragged, kernel, plain,
                lambda a: slot_bound(a, narrow))

    # the full-width fused verify's operands end with the packed query words
    wide_ragged = [ragged_fused_wide(dev, ops), ragged_fused_wide(dev, ops, W=1, seed=8),
                   ragged_fused_wide(dev, ops, M=9, T=7, K=13, OBJ=45, W=40, sparse=True,
                                     seed=9)]
    # rows 7 and 8 also at NaN and infinite query points (NONFINITE_POINTS),
    # and at one NaN point alone
    level_ragged = [ragged_level(dev, ops), ragged_level(dev, ops, M=1, F=1, N=1, W=1, seed=20),
                    ragged_level(dev, ops, M=9, F=300, N=200, W=64, sparse=True, seed=21),
                    ragged_level(dev, ops, seed=25, nonfinite=True),
                    ragged_level(dev, ops, M=1, F=3, N=2, W=1, seed=29, nonfinite=True)]
    # the narrow level's: Wp = W with dirty ids, a padding row and a query
    # with no nonzero word; N = 1 with one-entry dictionaries; Wp below W;
    # non-finite points; an all-padding frontier
    narrow_ragged = [ragged_level(dev, ops, D=61, seed=22),
                     ragged_level(dev, ops, M=1, F=1, N=1, W=1, D=1, seed=23),
                     ragged_level(dev, ops, M=9, F=300, N=200, W=64, sparse=True, D=150, seed=24),
                     ragged_level(dev, ops, D=61, seed=27, nonfinite=True),
                     ragged_level(dev, ops, M=1, F=3, N=2, W=1, D=2, seed=28, nonfinite=True)]
    pad = narrow_ragged[0]
    narrow_ragged.append(pad[:5] + (torch.full_like(pad[5], -1),) + pad[6:])

    def slot_verify_phase(name, replaces, kernel, plain, compact):
        # the insert slots of a delta SKR batch; ragged: dirty leaf ids,
        # leaf_ok = 0 rows, a query with no nonzero word and a NEVER_RECT
        # one, points on edges; B = 1; W = 1; W past one compaction round;
        # every slot empty
        ragged = [ragged_slot_bank(dev, ops, compact),
                  ragged_slot_bank(dev, ops, compact, M=7, T=3, K=5, B=1, W=2, seed=42),
                  ragged_slot_bank(dev, ops, compact, W=1, B=16, seed=43),
                  ragged_slot_bank(dev, ops, compact, M=5, T=3, K=9, B=16, W=2100, seed=44),
                  ragged_slot_bank(dev, ops, compact, seed=45, empty=True)]
        return (name, csrc + "skr_verify.cu", replaces, [captured[f"{name}/delta"]], ragged,
                kernel, plain, lambda a: slot_verify_bound(a, compact))

    phases = [
        slot_phase("frontier_level_narrow", "src/repro/kernels/frontier.py:113",
                   [captured["frontier_level_narrow"]], ops.frontier_level_narrow,
                   ref.frontier_level_narrow_ref, True),
        ("fused_verify_remap_tile", csrc + "fused_verify_compact.cu",
         "src/repro/kernels/fused_verify.py:267", fu_cases, remap_ragged, remap_entry("vmem"),
         remap_plain, remap_bound),
        ("fused_verify_remap_slot", csrc + "fused_verify_compact.cu",
         "src/repro/kernels/fused_verify.py:345", fu_cases, remap_ragged, remap_entry("prefetch"),
         remap_plain, remap_bound),
        slot_phase("frontier_level", "src/repro/kernels/frontier.py:60",
                   [captured["frontier_level/log B"], captured["frontier_level/f32"],
                    captured["frontier_level/log A"]],
                   ops.frontier_level, ref.frontier_level_ref, False),
        ("knn_level_dist_narrow", csrc + "knn_filter.cu", "src/repro/kernels/knn_filter.py:105",
         [captured["knn_level_dist_narrow"]], narrow_ragged, ops.knn_level_dist_narrow,
         ref.knn_level_dist_narrow_ref, lambda a: level_bound(a, narrow=True)),
        ("knn_level_dist", csrc + "knn_filter.cu", "src/repro/kernels/knn_filter.py:54",
         [captured["knn_level_dist"]], level_ragged, ops.knn_level_dist, ref.knn_level_dist_ref,
         level_bound),
        ("fused_verify_tile", csrc + "fused_verify.cu", "src/repro/kernels/fused_verify.py:107",
         [captured["fused_wide"]], wide_ragged,
         lambda *a: ops.fused_gather_verify(*a[:8], variant="vmem", q_words=a[8]),
         lambda *a: ref.fused_verify_packed_ref(a[0], *a[8], *a[2:8]),
         lambda a: fused_wide_bound(a[:8])),
        ("fused_verify_slot", csrc + "fused_verify.cu", "src/repro/kernels/fused_verify.py:176",
         [captured["fused_wide"]], wide_ragged,
         lambda *a: ops.fused_gather_verify(*a[:8], variant="prefetch"),
         lambda *a: ref.fused_verify_ref(*a[:8]), lambda a: fused_wide_bound(a[:8])),
        slot_verify_phase("skr_verify_slots_compact", "src/repro/kernels/skr_verify.py:94",
                          ops.verify_slots_compact, ref.skr_verify_slots_compact_ref, True),
        slot_verify_phase("skr_verify_slots", "src/repro/kernels/skr_verify.py:39",
                          ops.verify_slots, ref.skr_verify_slots_ref, False),
        # row 11: the stream's pairs instance (the row's time), then the
        # matrix instance; ragged: W of 1, 3 and 40, S = 1, matches decided
        # past the words the pairs instance stages, sizes off every block
        ("sub_match_pairs", csrc + "sub_match.cu", "src/repro/kernels/sub_match.py:67",
         [captured["sub_match_pairs"]],
         [ragged_sub(dev, ops, pairs=True), ragged_sub(dev, ops, N=1, S=1, W=1, seed=18, pairs=True),
          ragged_sub(dev, ops, N=70, S=300, W=40, seed=19, pairs=True, late=True),
          ragged_sub(dev, ops, N=1000, S=4099, W=256, seed=20, pairs=True)],
         lambda *a: canon(ops.match_subscription_pairs(*a), a[2].shape[0]),
         lambda *a: canon(plain_pairs(*a), a[2].shape[0]), sub_bound),
        ("sub_match", csrc + "sub_match.cu", "src/repro/kernels/sub_match.py:67",
         [captured["sub_match"]],
         [ragged_sub(dev, ops), ragged_sub(dev, ops, N=1, S=1, W=1, seed=18),
          ragged_sub(dev, ops, N=1000, S=4099, W=256, seed=20)],
         ops.sub_match, ref.sub_match_packed_ref, sub_bound),
        # row 12: the leaf level (the row's time), then the dense batch's
        # four upper levels; ragged: node runs and strips cut short, rows
        # not 16-byte aligned (K = 7833), W of 1, 3 and 2,100 (past a
        # compaction round, sparse and dense)
        ("skr_filter", csrc + "skr_filter.cu", "src/repro/kernels/skr_filter.py:44",
         [captured["skr_filter"], *dense_levels[:-1]],
         [ragged_filter(dev, ops.NEVER_RECT), ragged_filter(dev, ops.NEVER_RECT, M=1, K=1, W=1,
                                                             seed=14),
          ragged_filter(dev, ops.NEVER_RECT, M=17, K=15, seed=15),
          ragged_filter(dev, ops.NEVER_RECT, M=5, K=7833, seed=16),
          ragged_filter(dev, ops.NEVER_RECT, M=6, K=17, W=2100, seed=17, sparse=True),
          ragged_filter(dev, ops.NEVER_RECT, M=4, K=40, W=2100, seed=18)],
         ops.filter_pairs, ref.skr_filter_ref, filter_bound),
        ("cdf_mlp_bank", csrc + "cdf_mlp.cu", "src/repro/kernels/cdf_mlp.py:42",
         [captured["cdf_mlp_bank"]],
         [cdf_bank(dev, 5, CDF_HIDDEN, gen), cdf_bank(dev, 3, 8, gen, N=4099),
          cdf_bank(dev, 1, 4, gen, N=1), cdf_bank(dev, 9, 32, gen, N=2081, edges=True),
          cdf_bank(dev, 7, CDF_HIDDEN, gen, N=97, edges=True),
          cdf_bank(dev, 196, 8, gen, N=5000, edges=True)],
         ops.cdf_bank_forward, ref.cdf_mlp_ref, cdf_bound),
    ]
    atols = {"cdf_mlp_bank": CDF_ATOL}  # every other kernel is held bit for bit
    # timed as one launch at the default capacity, without the count
    # readback and the canonical sort the checked entry adds
    timed = {"sub_match_pairs": (
        lambda *a: ops._sub_pairs(*a, ops.SUB_PAIRS_CAPACITY),
        lambda *a: ref.sub_match_pairs_ref(*a, ops.SUB_PAIRS_CAPACITY))}
    launches.update(knob_launches)
    launches.update(delta_launches)
    with phase("kernel phases"):
        # the first captured case is the row's; later ones (more paths'
        # shapes) are checked and timed the same way and logged
        for name, source, replaces, cases, ragged, kernel, plain, bound in phases:
            atol = atols.get(name, 0.0)
            for case in [*cases, *ragged]:
                got = kernel(*case)
                torch.cuda.synchronize()
                assert_same(got, plain(*case), f"{name} at {shapes(case)[:5]}", atol)
            for ci, args in enumerate(cases):
                err = max_abs_err(kernel(*args), plain(*args))
                torch.cuda.synchronize()
                run, run_plain = timed.get(name, (kernel, plain))
                ms, note = kernel_ms(lambda: run(*args))
                plain_ms = time_ms(lambda: run_plain(*args), iters=10)
                nbytes, nops = bound(args)
                b_ms, b_by = bound_ms(nbytes, nops)
                agree = "bit-exact" if atol == 0 else f"within atol {atol} (max {err:.3e})"
                log(f"phase {name}: {agree} vs plain at main-path shapes {shapes(args)} and "
                    f"{len(ragged)} ragged cases; kernel {note}, plain {plain_ms:.6f} ms, bound "
                    f"{b_ms:.6f} ms ({b_by}: {nbytes} B, {nops} ops)")
                if ci == 0:
                    rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                                     launches=launches[name], max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                     library_ms=None))

    with phase("the other entries of the redesigned kernels"):
        # the gather the f32 kNN descent no longer makes: the (M, F, W) word
        # plane at the captured leaf frontier, as the one indexing op it was
        q_pts, wids, bits, mbrs, lbms, fr = captured["knn_level_dist"]
        safe = fr.clamp(0, lbms.shape[0] - 1).long()
        gather_ms = time_ms(lambda: lbms[safe], iters=10)
        log(f"the removed gather level_bms[safe] at {tuple(fr.shape)} x W={lbms.shape[1]} "
            f"({fr.numel() * lbms.shape[1] * 4} B): {gather_ms:.6f} ms")
        del safe
        # knn_frontier_dist's gathered operands run the same kernel: bit-exact
        # against knn_filter_ref at ragged shapes and at the first 64 captured
        # queries, where it also equals knn_level_dist's rows
        m = min(64, fr.shape[0])
        sl = fr[:m].clamp(0, lbms.shape[0] - 1).long()
        q_head = torch.zeros((m, lbms.shape[1]), dtype=torch.int32, device=dev).scatter_(
            1, wids[:m].long(), bits[:m])  # every word of the first m queries
        head = (q_pts[:m].contiguous(), q_head, mbrs[sl], lbms[sl], (fr[:m] >= 0).to(torch.int8))
        gathered = [ragged_slots(dev, False, True),
                    ragged_slots(dev, False, True, M=1, F=1, W=1, D=2, seed=9), head]
        for case in gathered:
            got = ops.knn_frontier_dist(*case)
            torch.cuda.synchronize()
            assert_same(got, ref.knn_filter_ref(*case), f"knn_frontier_dist at {shapes(case)}")
        assert_same(got, ops.knn_level_dist(q_pts[:m].contiguous(), wids[:m].contiguous(),
                                            bits[:m].contiguous(), mbrs, lbms,
                                            fr[:m].contiguous()), "knn_frontier_dist vs level")
        del head, gathered, sl, got
        # knn_frontier_dist_narrow's gathered planes run knn_level_dist_narrow's
        # kernel: bit-exact against knn_filter_narrow_ref at ragged shapes and
        # at the first 64 captured queries, where it also equals the level rows
        q_pts, wids, bits, codes, lbms, fr, dict_x, dict_y = captured["knn_level_dist_narrow"]
        m = min(64, fr.shape[0])
        sl = fr[:m].clamp(0, lbms.shape[0] - 1).long()
        head = (q_pts[:m].contiguous(), bits[:m].contiguous(), codes[sl],
                lbms[sl[:, :, None], wids[:m].long()[:, None, :]], (fr[:m] >= 0).to(torch.int8),
                dict_x, dict_y)
        gathered = [ragged_slots(dev, True, True),
                    ragged_slots(dev, True, True, M=1, F=1, W=1, D=2, seed=9), head]
        for case in gathered:
            got = ops.knn_frontier_dist_narrow(*case)
            torch.cuda.synchronize()
            assert_same(got, ref.knn_filter_narrow_ref(*case),
                        f"knn_frontier_dist_narrow at {shapes(case)}")
        assert_same(got, ops.knn_level_dist_narrow(
            q_pts[:m].contiguous(), wids[:m].contiguous(), bits[:m].contiguous(), codes, lbms,
            fr[:m].contiguous(), dict_x, dict_y), "knn_frontier_dist_narrow vs level")
        del head, gathered, sl, got
        # the tile launch without packed words takes all W words, ids arange(W)
        for case in [captured["fused_wide"], *wide_ragged]:
            got = ops.fused_gather_verify(*case[:8], variant="vmem")
            torch.cuda.synchronize()
            assert_same(got, ref.fused_verify_ref(*case[:8]),
                        f"fused_verify_tile on q_bm at {shapes(case[:8])}")
        # filter_frontier(_narrow)'s gathered planes run the frontier level
        # kernels: bit-exact against frontier_filter(_narrow)_ref at ragged
        # shapes and at the first 64 captured queries, where they also equal
        # the level rows
        for key, narrow in (("frontier_level/log B", False), ("frontier_level_narrow", True)):
            level = captured[key]
            q_rects, q_bm, mbr, lbms, fr = level[:5]
            m = min(64, fr.shape[0])
            sl = fr[:m].clamp(0, lbms.shape[0] - 1).long()
            valid = (fr[:m] >= 0).to(torch.int8)
            if narrow:
                wids, bits = ops.pack_query_words(ops.host_words(q_bm[:m]))
                wids, bits = torch.from_numpy(wids).to(dev), torch.from_numpy(bits.view(np.int32)).to(dev)
                head = (q_rects[:m].contiguous(), bits, mbr[sl],
                        lbms[sl[:, :, None], wids.long()[:, None, :]], valid, *level[5:])
                wrapper, plain = ops.filter_frontier_narrow, ref.frontier_filter_narrow_ref
            else:
                head = (q_rects[:m].contiguous(), q_bm[:m].contiguous(), mbr[sl], lbms[sl], valid)
                wrapper, plain = ops.filter_frontier, ref.frontier_filter_ref
            gathered = [ragged_slots(dev, narrow, False),
                        ragged_slots(dev, narrow, False, M=1, F=1, W=1, D=2, seed=9), head]
            for case in gathered:
                got = wrapper(*case)
                torch.cuda.synchronize()
                assert_same(got, plain(*case), f"{wrapper.__name__} at {shapes(case)}")
            rows_m = (q_rects[:m].contiguous(), q_bm[:m].contiguous(), mbr, lbms,
                      fr[:m].contiguous(), *level[5:])
            level_fn = ops.frontier_level_narrow if narrow else ops.frontier_level
            assert_same(got, level_fn(*rows_m), f"{wrapper.__name__} vs level")
            del head, gathered, sl, got
        # the given-words instances of rows 2 and 3 (fused_gather_verify_compact,
        # on the words remap_query_words gives) at the main path's remapped
        # words and at ragged ones: bit-exact, and timed beside fused_bound
        q_cbm, q_sig = ref.remap_query_words_ref(*fu_args[1:4])
        given = (fu_args[0], q_cbm, q_sig, *fu_args[3:])
        for variant, name in (("vmem", "fused_verify_compact_tile"),
                              ("prefetch", "fused_verify_compact_slot")):
            entry = lambda *a, variant=variant: ops.fused_gather_verify_compact(  # noqa: E731
                *a, variant=variant)
            for case in [given, *fused_ragged]:
                got = entry(*case)
                torch.cuda.synchronize()
                assert_same(got, plain_fused(*case), f"{name} at {shapes(case)[:5]}")
            ms = time_ms(lambda: entry(*given))
            b_ms, b_by = bound_ms(*fused_bound(given))
            log(f"{name} (given words) at the main path's remapped words {shapes(given)[:5]}: "
                f"bit-exact vs plain, and at {len(fused_ragged)} ragged cases; kernel {ms:.6f} ms, "
                f"bound {b_ms:.6f} ms ({b_by})")
        del given, q_cbm, q_sig, got
        log("knn_frontier_dist, knn_frontier_dist_narrow, filter_frontier and "
            "filter_frontier_narrow (gathered operands, through the level kernels) and the "
            "query-tile verify on q_bm: bit-exact against their plain versions at the captured "
            "and ragged shapes")
        # the gathered entries of rows 9 and 10 run the slot kernels over an
        # identity leaf map: the counted ones (the unfused knob's verify)
        # bit-exact in ids, n_match and n_kw against their plain versions at
        # the knob shapes and ragged ones, timed at the knob shapes; the int8
        # ones against skr_verify(_compact)_ref at ragged shapes
        for compact, counted, flags, plain_flags in (
                (True, ops.verify_candidates_compact_counted, ops.verify_candidates_compact,
                 ref.skr_verify_compact_ref),
                (False, ops.verify_candidates_counted, ops.verify_candidates,
                 ref.skr_verify_ref)):
            key = "skr_verify_compact" if compact else "skr_verify"

            def plain_counted(*a, compact=compact):
                M = a[0].shape[0]
                T = a[2].shape[1] if compact else 1
                leaves = ops.identity_leaves(M, T, dev)
                if not compact:
                    return ref.skr_verify_slots_ref(a[0], a[1], *leaves, *a[2:])
                bank = lambda t: t.reshape(M * T, -1, *t.shape[2:])  # noqa: E731
                return ref.skr_verify_slots_compact_ref(*a[:3], *leaves,
                                                        *(bank(t) for t in a[3:]))

            ragged = [ragged_verify(dev, compact), ragged_verify(dev, compact, W=1, seed=12)]
            as_ids = lambda a: a[:-1] + ((a[-1] > 0).to(torch.int32) * 7 - 1,)  # noqa: E731
            knob = captured[f"{key}/knob"]
            for case in [knob, *map(as_ids, ragged)]:
                got = counted(*case)
                torch.cuda.synchronize()
                assert_same(got, plain_counted(*case), f"{key} counted at {shapes(case)[:5]}")
            for case in ragged:
                got = flags(*case)
                torch.cuda.synchronize()
                assert_same(got, plain_flags(*case), f"{key} at {shapes(case)[:5]}")
            ms = time_ms(lambda: counted(*knob))
            plain_ms = time_ms(lambda: plain_counted(*knob), iters=10)
            b_ms, b_by = bound_ms(*verify_bound(knob, compact))
            log(f"{key} (gathered, counted) at the knob shapes {shapes(knob)[:6]}: bit-exact in "
                f"ids, n_match and n_kw vs plain, and at {len(ragged)} ragged cases; the int8 "
                f"entry bit-exact at them; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
                f"{b_ms:.6f} ms ({b_by})")

        # the pairs instance at capacity 0 and 1 at the stream's captured
        # operands: one more launch, at the exact count, and the same pairs
        pa = captured["sub_match_pairs"]
        want = canon(ops.match_subscription_pairs(*pa), pa[2].shape[0])
        for cap in (0, 1):
            before = _build.KERNELS["sub_match_pairs"].launches
            got = canon(ops.match_subscription_pairs(*pa, capacity=cap), pa[2].shape[0])
            torch.cuda.synchronize()
            extra = _build.KERNELS["sub_match_pairs"].launches - before - 1
            if extra != int(want.shape[0] > cap) or not torch.equal(got, want):
                raise AssertionError(f"sub_match_pairs at capacity {cap}: {extra} retries, or "
                                     f"other pairs")
        log(f"sub_match_pairs at capacity 0 and 1 at the stream's operands: one retry each at the "
            f"exact count ({want.shape[0]} pairs), the same pairs as at the default capacity")
        del pa, want, got

    with phase("operand gathers"):
        # the per-slot planes the engine gathered before rows 1, 4 and 7
        # read the level themselves, timed at the captured shapes as the
        # indexing ops that made them: row 1's codes and node words at the
        # packed word ids (the narrow SKR descent), row 4's f32 MBRs and all
        # W words (log B's delta SKR batch), row 7's codes and node words
        # (the narrow kNN descent); and the host packing the SKR batch no
        # longer makes
        def narrow_planes(codes, lbms, fr, wids):
            safe = fr.clamp(0, lbms.shape[0] - 1).long()
            return codes[safe], lbms[safe[:, :, None], wids.long()[:, None, :]]

        def wide_planes(mbrs, lbms, fr):
            safe = fr.clamp(0, lbms.shape[0] - 1).long()
            return mbrs[safe], lbms[safe]

        q_rects, q_bm, codes1, lbms1, fr1 = captured["frontier_level_narrow"][:5]
        host_bm = ops.host_words(q_bm)
        t = time.perf_counter()
        for _ in range(5):
            wids1, _ = ops.pack_query_words(host_bm)
        pack_ms = (time.perf_counter() - t) * 1e3 / 5
        wids1 = torch.from_numpy(wids1).to(dev)
        _, _, mbrs4, lbms4, fr4 = captured["frontier_level/log B"]
        _, wids7, _, codes7, lbms7, fr7 = captured["knn_level_dist_narrow"][:6]
        gathers = {
            "frontier_level_narrow (row 1)": lambda: narrow_planes(codes1, lbms1, fr1, wids1),
            "frontier_level (row 4)": lambda: wide_planes(mbrs4, lbms4, fr4),
            "knn_level_dist_narrow (row 7)": lambda: narrow_planes(codes7, lbms7, fr7, wids7),
        }
        # rows 9 and 10: the insert-slot planes _verify_delta_slots gathered
        # at logs A's and B's delta SKR batches (coordinates, ids, the int8
        # validity plane and the slot words), and the keyword recount over
        # them (_kw_compact, _kw_full) that gave Eq. 1's verified
        def slot_planes(args, compact):
            top_leaf, leaf_ok, x, y = args[3:7] if compact else args[2:6]
            M, B = top_leaf.shape[0], x.shape[1]
            tl = top_leaf.long()
            iid = args[-1][tl].reshape(M, -1)
            ival = ((iid >= 0) & (leaf_ok > 0).repeat_interleave(B, dim=1)).to(torch.int8)
            planes = [x[tl].reshape(M, -1), y[tl].reshape(M, -1), iid, ival]
            words = args[7] if compact else args[6]
            planes.append(words[tl].reshape(M, -1, words.shape[2]))
            if compact:
                planes.append(args[8][tl].reshape(M, -1))
            return planes

        def recount(args, planes, compact):
            B = args[-1].shape[1]
            if compact:
                q_cbm, q_sig = args[1], args[2]
                kw = (((planes[5] & q_sig.repeat_interleave(B, dim=1)) != 0)
                      & ((planes[4] & q_cbm.repeat_interleave(B, dim=1)) != 0).any(dim=-1))
            else:
                kw = ((planes[4] & args[1][:, None, :]) != 0).any(dim=-1)
            return (kw & (planes[3] > 0)).to(torch.int32).sum(dim=1, dtype=torch.int32)

        for row, key, compact in (("skr_verify_slots_compact (row 9)",
                                   "skr_verify_slots_compact/delta", True),
                                  ("skr_verify_slots (row 10)", "skr_verify_slots/delta", False)):
            args = captured[key]
            gathers[row] = lambda args=args, compact=compact: slot_planes(args, compact)
            planes = slot_planes(args, compact)
            r_ms = time_ms(lambda: recount(args, planes, compact), iters=10)
            log(f"keyword recount no longer made for {row}: over the planes "
                f"{[tuple(p.shape) for p in planes[3:]]}: {r_ms:.6f} ms")
            del planes
        for row, gather in gathers.items():
            planes = gather()
            nbytes = sum(p.numel() * p.element_size() for p in planes)
            g_ms = time_ms(gather, iters=10)
            log(f"operand gather no longer made for {row}: planes "
                f"{[tuple(p.shape) for p in planes]} ({nbytes} B): {g_ms:.6f} ms")
        log(f"host packing no longer made for the SKR batch: pack_query_words of "
            f"{tuple(host_bm.shape)} words, host clock, mean of 5: {pack_ms:.6f} ms")
        # the per-slot query words rows 2 and 3 took before their kernels
        # remapped them: remap_query_words at the main path's (M, T) slots
        remap = fu_args[1:4]
        remap_ms = time_ms(lambda: ops.remap_query_words(*remap), iters=10)
        log(f"operand build no longer made for rows 2-3: remap_query_words of q_bm "
            f"{tuple(remap[0].shape)} into the leaf dictionaries {tuple(remap[1].shape)} at "
            f"the (M, T) = {tuple(remap[2].shape)} slots: {remap_ms:.6f} ms")
        del planes, gathers
        # what the subscription stream no longer makes: the host packing of
        # an arrival batch's words (pack_query_words and the OR-fold) and
        # torch.nonzero over the (N, S) match matrix with the copy of its
        # indices, host clock, mean of 5
        host_obm = ops.host_words(captured["sub_match_pairs"][1])
        t = time.perf_counter()
        for _ in range(5):
            ops.pack_query_words(host_obm)
            np.bitwise_or.reduce(host_obm, axis=1)
        sub_pack_ms = (time.perf_counter() - t) * 1e3 / 5
        mat = ops.sub_match(*captured["sub_match"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            [x.cpu() for x in torch.nonzero(mat, as_tuple=True)]
        nonzero_ms = (time.perf_counter() - t) * 1e3 / 5
        log(f"subscription match steps no longer made: host packing of {tuple(host_obm.shape)} "
            f"arrival words {sub_pack_ms:.6f} ms; torch.nonzero over the {tuple(mat.shape)} match "
            f"matrix and the copy of its {int(mat.sum())} index pairs {nonzero_ms:.6f} ms")
        del mat
    captured.clear()

    with phase("profiles"):
        profile_batch("SKR", lambda cache: serve_batch(
            snap, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=cache), warm, PlanCache)
        profile_batch(f"kNN (k={K})", lambda cache: serve_knn_batch(
            snap, points[b0], bms[b0], K, plan_cache=cache), warm_knn, PlanCache)
        profile_batch("dense SKR", lambda cache: serve_batch(
            snap, wl.rects[b0], bms[b0], MAX_LEAVES, mode="dense"), warm, PlanCache)
        for label in ("B", "A"):
            serve = lambda cache, label=label: serve_batch(  # noqa: E731
                snap, wl.rects[b0], bms[b0], MAX_LEAVES, plan_cache=cache,
                delta=delta_bufs[label])
            profile_batch(f"SKR with log {label}'s delta", serve, delta_caches[label], PlanCache)

    # --------------------------------------------------------- construction
    with phase("construction"):
        construction(dev, ds, wl, batches, main_out)

    log(f"card: {card}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
