#!/usr/bin/env python3
"""Batch latencies of the PyTorch/CUDA port's serving paths, for comparing two
trees on one GPU.

Run it once per tree, in turns on one card (tree A, tree B, tree B,
tree A), pointing ``--src`` at each tree's ``src`` directory:

    python3 tools/serve_ab.py --src /path/to/parent/src --label parent
    python3 tools/serve_ab.py --label change

It builds the ``osm`` synthetic profile at 1,000,000 objects (STR R-tree,
leaf 128, fanout 8) and the 4096-query MIX workload in 4 batches of 1024 --
the configuration of ``chip_smoke.py`` -- warms every path up once, then
times each batch (host clock after ``torch.cuda.synchronize``) of:

* SKR ``serve_batch`` (the narrow descent, the compact fused verify's
  (M, T) launch) and ``retrieve(fused_variant="vmem")`` (its query-tile
  launch);
* SKR ``retrieve(compact=False, fused_variant="vmem")`` (the full-width
  fused verify's query-tile launch);
* SKR ``retrieve(compact=False)`` (``variant="auto"``: the full-width
  fused verify's (M, T) launch);
* SKR ``retrieve(quantized=False)`` (the f32 descent);
* SKR ``serve_batch(delta=...)`` and kNN ``serve_knn_batch(delta=...)``
  over a ``DeltaLog`` of 10,000 inserts with their own keywords and 5,000
  deletes (the f32 descents on the widened level arrays);
* SKR ``serve_batch(delta=...)`` over a second ``DeltaLog`` whose 10,000
  inserts carry terms of the leaf they route to, so its insert slots stay
  on the compact words (``skr_delta_compact``);
* SKR ``serve_batch(mode="dense")`` (the dense A/B scan; the snapshot is
  built with ``dense=True``);
* kNN ``serve_knn_batch`` at k = 10 (the narrow descent);
* kNN ``retrieve_knn(quantized=False)`` (the f32 descent);
* ``sub_arrivals``: 10 batches of 1,000 arrivals (inserted into a
  ``DeltaLog`` on their leaf's terms, as ``chip_smoke.py``'s log A) through
  ``SubscriptionIndex.match_arrivals`` against 100,000 standing
  subscriptions (a MIX workload, seed 2): host seconds per batch, the first
  one compiling the block.

``--paths`` picks some of them (default: all; ``none`` builds no index and
times no path). With ``--kernels`` it also takes, from ``torch.profiler``
(``chip_smoke.device_ms``, so it runs from a checkout that holds
``chip_smoke.py``), the mean device time of a launch of the dense filter at
each level of the first batch (``skr_filter``), of the match matrix entry
(``ops.match_subscriptions``) on the first arrival batch and, where the
tree has it, of the pairs entry (``ops.match_subscription_pairs``)
(``sub_match``), and of the CDF-MLP bank (``ops.cdf_bank_forward``,
``cdf_mlp_bank``) at N = 1,000,000 points, B = 196 MLPs, H = 16 -- the
smoke's shape -- with weights and points drawn from a seed; ``--kernels
cdf_mlp_bank`` (a comma-separated list) times only those. ``--cdf-out``
saves the bank's (N, B) output (``torch.save``), and ``--cdf-against``
prints the largest difference of this tree's output from a saved one, a
NaN against a NaN counting 0: two trees' kernels compared on one card,

    python3 tools/serve_ab.py --src old/src --label old --paths none \
        --kernels cdf_mlp_bank --cdf-out _ab/old.pt
    python3 tools/serve_ab.py --label new --paths none --kernels cdf_mlp_bank \
        --cdf-against _ab/old.pt

It uses only entry points every tree of the port since its dense and
subscription slice has (the pairs entry only where it exists), checks
nothing (``chip_smoke.py`` does), and prints the card (``nvidia-smi`` name
and power limit) and one JSON line of batch seconds and kernel ms. It needs
a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_OBJECTS = 1_000_000
N_QUERIES = 4096
BATCH = 1024
K = 10
KERNEL_GROUPS = ("skr_filter", "sub_match", "cdf_mlp_bank")
CDF_N, CDF_B, CDF_H = 1_000_000, 196, 16  # chip_smoke.py's bank


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="the src directory of the tree to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--paths", default="", help="comma-separated paths to time (default: all; "
                    "none: no path)")
    ap.add_argument("--kernels", nargs="?", const=",".join(KERNEL_GROUPS), default="",
                    help="also time kernels on the device: a comma-separated list of "
                    f"{', '.join(KERNEL_GROUPS)} (default: all)")
    ap.add_argument("--cdf-out", default="", help="save the CDF bank's output to this file")
    ap.add_argument("--cdf-against", default="", help="a saved CDF bank output to compare with")
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    if set(kernels) - set(KERNEL_GROUPS):
        raise SystemExit(f"unknown kernels {sorted(set(kernels) - set(KERNEL_GROUPS))}")
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.baselines.conventional import build_str_rtree
    from repro_torch.data.synth import make_dataset
    from repro_torch.data.workloads import make_update_stream, make_workload
    from repro_torch.launch.wisk_serve import serve_batch, serve_knn_batch
    from repro_torch.serve.delta import DeltaLog
    from repro_torch.serve.engine import retrieve, retrieve_knn
    from repro_torch.serve.plan import PlanCache
    from repro_torch.serve.snapshot import IndexSnapshot
    from repro_torch.serve.subscribe import SubscriptionIndex

    import repro_torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {args.label}: {Path(repro_torch.__file__).parent}", flush=True)
    kernel_ms = {}
    if "cdf_mlp_bank" in kernels:
        kernel_ms["cdf_mlp_bank"] = time_cdf(args.cdf_out, args.cdf_against, args.label)
    if args.paths == "none" and not set(kernels) - {"cdf_mlp_bank"}:
        print(json.dumps({"label": args.label, "card": card, "batch_s": {},
                          "kernel_ms": kernel_ms}), flush=True)
        return 0
    ds = make_dataset("osm", n=N_OBJECTS, seed=0)
    index = build_str_rtree(ds, leaf_size=128, fanout=8)
    snap = IndexSnapshot.build(index, ds, device=torch.device("cuda:0"), dense=True)
    wl = make_workload(ds, m=N_QUERIES, dist="MIX", seed=1)
    points = np.stack([(wl.rects[:, 0] + wl.rects[:, 2]) / 2,
                       (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1).astype(np.float32)
    bms = wl.kw_bitmap
    batches = [np.arange(i, i + BATCH) for i in range(0, N_QUERIES, BATCH)]
    rng = np.random.default_rng(22)
    dlog = DeltaLog(index, ds, snap)
    new_ids = []
    for _ in range(10):
        locs, kw = make_update_stream(ds, 1000, rng, 0.05)
        new_ids.append(dlog.insert(locs, kw))
    dlog.delete(np.concatenate([rng.choice(ds.n, 4900, replace=False),
                                rng.choice(np.concatenate(new_ids), 100, replace=False)]))
    buf = dlog.buffer
    clog = DeltaLog(index, ds, snap)  # inserts on their leaf's terms: compact insert slots
    vocab = (index.levels[-1].mbrs, snap.leaf_terms.cpu().numpy())
    for _ in range(10):
        clog.insert(*make_update_stream(ds, 1000, rng, 1e-3, *vocab))
    cbuf = clog.buffer

    paths = {
        "skr": lambda b, c: serve_batch(snap, wl.rects[b], bms[b], 32, plan_cache=c),
        "skr_vmem": lambda b, c: retrieve(snap, wl.rects[b], bms[b], 32, plan_cache=c,
                                          fused_variant="vmem"),
        "skr_full_width_vmem": lambda b, c: retrieve(snap, wl.rects[b], bms[b], 32, plan_cache=c,
                                                     compact=False, fused_variant="vmem"),
        "skr_full_width": lambda b, c: retrieve(snap, wl.rects[b], bms[b], 32, plan_cache=c,
                                                compact=False),
        "skr_f32": lambda b, c: retrieve(snap, wl.rects[b], bms[b], 32, plan_cache=c,
                                         quantized=False),
        "skr_delta": lambda b, c: serve_batch(snap, wl.rects[b], bms[b], 32, plan_cache=c,
                                              delta=buf),
        "skr_delta_compact": lambda b, c: serve_batch(snap, wl.rects[b], bms[b], 32,
                                                      plan_cache=c, delta=cbuf),
        "skr_dense": lambda b, c: serve_batch(snap, wl.rects[b], bms[b], 32, mode="dense"),
        "knn": lambda b, c: serve_knn_batch(snap, points[b], bms[b], K, plan_cache=c),
        "knn_f32": lambda b, c: retrieve_knn(snap, points[b], bms[b], K, plan_cache=c,
                                             quantized=False),
        "knn_delta": lambda b, c: serve_knn_batch(snap, points[b], bms[b], K, plan_cache=c,
                                                  delta=buf),
    }
    chosen = [p for p in args.paths.split(",") if p]
    unknown = set(chosen) - set(paths) - {"sub_arrivals", "none"}
    if unknown:
        raise SystemExit(f"unknown paths {sorted(unknown)}")
    times = {}
    for name, serve in paths.items():
        if chosen and name not in chosen:
            continue
        warm = PlanCache()
        for b in batches:  # warm-up: builds, learns the widths
            serve(b, warm)
        torch.cuda.synchronize()
        cache = PlanCache()
        cache.widths = dict(warm.widths)
        times[name] = []
        for b in batches:
            t = time.perf_counter()
            serve(b, cache)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
        print(f"{args.label} {name}: batch s {times[name]}", flush=True)
    sub_idx, arrivals = None, []
    if not chosen or "sub_arrivals" in chosen or "sub_match" in kernels:
        subs = make_workload(ds, m=100_000, dist="MIX", seed=2)
        sub_idx = SubscriptionIndex(ds.vocab_size, device=torch.device("cuda:0"))
        for r, kw in zip(subs.rects, subs.kw_ids):
            sub_idx.subscribe(r, kw)
        alog, arng = DeltaLog(index, ds, snap), np.random.default_rng(21)
        for _ in range(10):
            locs, kw = make_update_stream(ds, 1000, arng, 1e-3, *vocab)
            arrivals.append((alog.insert(locs, kw), locs, kw))
    if not chosen or "sub_arrivals" in chosen:
        times["sub_arrivals"] = []
        for ids, locs, kw in arrivals:
            t = time.perf_counter()
            sub_idx.match_arrivals(ids, locs, kw_ids=kw)
            torch.cuda.synchronize()
            times["sub_arrivals"].append(time.perf_counter() - t)
        print(f"{args.label} sub_arrivals: batch s {times['sub_arrivals']}, "
              f"{sub_idx.n_pending} notifications", flush=True)
    if set(kernels) - {"cdf_mlp_bank"}:
        kernel_ms.update(time_kernels(snap, wl, bms, batches[0], sub_idx,
                                      arrivals[0] if arrivals else None, ds.vocab_size, kernels))
        print(f"{args.label} kernel device ms per launch: {kernel_ms}", flush=True)
    print(json.dumps({"label": args.label, "card": card, "batch_s": times,
                      "kernel_ms": kernel_ms}), flush=True)
    return 0


def _device_ms():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import device_ms

    return lambda fn: device_ms(fn)[0]


def time_cdf(out_path: str, against: str, label: str) -> float:
    """Device ms per launch of ``ops.cdf_bank_forward`` at the smoke's
    shape, on He-scale weights and uniform points from seed 0; saves the
    output to ``out_path`` and compares it with ``against`` where given."""
    from repro_torch.kernels import ops

    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    shapes = dict(w0=(CDF_B, 1, CDF_H), b0=(CDF_B, CDF_H), w1=(CDF_B, CDF_H, CDF_H),
                  b1=(CDF_B, CDF_H), w2=(CDF_B, CDF_H, CDF_H), b2=(CDF_B, CDF_H),
                  w3=(CDF_B, CDF_H, 1), b3=(CDF_B, 1))
    params = {k: (torch.randn(s, generator=gen) * ((2.0 / s[1]) ** 0.5 if k[0] == "w" else 0.1))
              .to(dev) for k, s in shapes.items()}
    x = torch.rand(CDF_N, generator=gen).to(dev)
    ms = _device_ms()(lambda: ops.cdf_bank_forward(params, x))
    out = ops.cdf_bank_forward(params, x)
    torch.cuda.synchronize()
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(out.cpu(), out_path)
    if against:
        old = torch.load(against).to(dev)
        same = (out == old) | (torch.isnan(out) & torch.isnan(old))
        diff = torch.where(same, 0.0, (out.double() - old.double()).abs()).max()
        print(f"{label} cdf_mlp_bank: max abs difference from {against}: {float(diff):.3e}, "
              f"{int((~same).sum())} of {out.numel()} outputs differ", flush=True)
    print(f"{label} cdf_mlp_bank: {ms:.6f} ms on the device a launch at N={CDF_N} B={CDF_B} "
          f"H={CDF_H}", flush=True)
    return ms


def time_kernels(snap, wl, bms, b, sub_idx, arrival, vocab_size, kernels):
    """Device ms per launch of the dense filter at every level (batch
    ``b``'s queries) and of the match entries (``arrival`` against the
    subscription block), as ``kernels`` asks."""
    from repro_torch.core.types import ids_to_bitmap
    from repro_torch.kernels import ops

    ms = _device_ms()
    dev = snap.level_mbrs[0].device
    out = {}
    if "skr_filter" in kernels:
        q_rects = torch.from_numpy(np.ascontiguousarray(wl.rects[b], np.float32)).to(dev)
        q_bm = torch.from_numpy(np.ascontiguousarray(bms[b]).view(np.int32)).to(dev)
        out["skr_filter"] = [ms(lambda li=li: ops.filter_pairs(
            q_rects, q_bm, snap.level_mbrs[li], snap.level_bms[li]))
            for li in range(len(snap.level_mbrs))]
    if "sub_match" not in kernels:
        return out
    ids, locs, kw = arrival
    obm = ids_to_bitmap(np.asarray(kw, np.int32).reshape(len(ids), -1), vocab_size)
    blk = sub_idx.block()
    sig = blk.sig[:, 0]
    out["sub_match"] = ms(lambda: ops.match_subscriptions(locs, obm, blk.rects, blk.bm, sig))
    if hasattr(ops, "match_subscription_pairs"):
        pts = torch.from_numpy(np.ascontiguousarray(locs, np.float32)).to(dev)
        obm_d = torch.from_numpy(obm.view(np.int32)).to(dev)
        out["sub_match_pairs"] = ms(lambda: ops.match_subscription_pairs(
            pts, obm_d, blk.rects, blk.bm, sig))
    return out


if __name__ == "__main__":
    sys.exit(main())
