"""The benchmark's harness: one cell of ``BENCHMARK.json``, one run.

A cell names a configuration (``configs/<name>.json``: the dataset, the
index and how it is served) and a traffic mix (``traffic/<name>.json``).
Each piece is found by name, so a later cell, configuration, mix or metric
is a new file and a new entry, and no file here changes:

* the configuration's ``index.kind`` names ``indexes/<kind>.py``, whose
  ``build`` makes the port's index from the generated objects;
* the traffic's ``kind`` names ``drivers/<kind>.py``, whose ``Driver``
  makes the query pool from the seed, serves one batch through the port's
  front door, keeps what the check needs and judges it against the plain
  reference after the window;
* every metric of the cell names ``metrics/<name>.py``, whose ``read(ctx)``
  returns the number or None when it finds nothing to read.

A run: set-up (objects from the frozen generator, the index, the snapshot,
the pool, a warm-up that builds the kernels and learns the plan's widths),
then a closed loop for ``seconds`` (one client, the next batch dispatched
once the last one's result is on the host), then, with ``trace``, a short
profiled stretch of the same loop, then the peak memory, and last the
check against the reference with the program's state freed.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
GIB = float(1 << 30)
BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under the benchmark's folder, as a module."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"wiskbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, its traffic and the
    metrics it reports (end-to-end with ``trace=0``, per-layer with 1)."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @staticmethod
    def from_spec(spec: Dict[str, Any], name: str) -> "Cell":
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in reported)]
        return Cell(
            name=name, chips=int(w["chips"]),
            config=load_json(ROOT / conf["file"]),
            traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            end_to_end=e2e, per_layer=layer,
        )


def data_seed(config: Dict[str, Any], seed: int) -> int:
    """The generator's seed: the configuration's ``data.seed``, where that is
    ``"run"`` a stream of the run's seed of its own."""
    from wiskbench.gen.pool import sub_seed

    fixed = config["data"]["seed"]
    return sub_seed(seed, 0) if fixed == "run" else int(fixed)


def make_objects(config: Dict[str, Any], seed: int):
    """The configuration's objects from the frozen generator, for a run of
    ``seed``."""
    from wiskbench.gen.synth import SynthConfig, synth_dataset

    fields = {f.name for f in dataclasses.fields(SynthConfig)}
    data = dict(config["data"], seed=data_seed(config, seed))
    return synth_dataset(SynthConfig(**{k: v for k, v in data.items() if k in fields}))


def to_port_dataset(data):
    from repro_torch.core.types import GeoTextDataset

    return GeoTextDataset(data.locs, data.kw_ids, data.kw_bitmap, data.vocab_size, data.kw_freq)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import _build

    return dict(_build.launch_counts())


class Context:
    """What the metric readers read: the window's latencies and counts, the
    set-up's phases, the device's readings and, in a traced run, the
    profiled stretch."""

    def __init__(self, cell: Cell) -> None:
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.latencies_s: List[float] = []
        self.window_s = 0.0
        self.record_s = 0.0  # in the driver's record(), left out of window_s
        self.queries = 0
        self.batches = 0
        self.counters: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        self.setup_s = 0.0
        self.build_s = 0.0
        self.snapshot_s = 0.0
        self.index_bytes = 0
        self.memory_peak_bytes = 0
        self.trace = None  # profiling.Trace of the profiled stretch
        self.trace_counters: Dict[str, int] = {}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
             log=print, min_batches: int = 1) -> Dict[str, Any]:
    """One run of ``cell``; returns the result line's object. ``t0`` is the
    host clock at the process's start, where set-up begins; the window
    serves at least ``min_batches`` batches."""
    import torch

    ctx = Context(cell)
    driver_mod = load_module("drivers", cell.traffic["kind"])
    index_mod = load_module("indexes", cell.config["index"]["kind"])

    data = make_objects(cell.config, seed)
    ds = to_port_dataset(data)
    driver = driver_mod.Driver(cell.traffic, cell.config, data, seed)

    t = time.perf_counter()
    index = index_mod.build(ds, data, cell.config["index"], device)
    _sync(device)
    ctx.build_s = time.perf_counter() - t

    from repro_torch.serve.snapshot import IndexSnapshot

    t = time.perf_counter()
    snap = IndexSnapshot.build(index, ds, device=device)
    _sync(device)
    ctx.snapshot_s = time.perf_counter() - t
    ctx.index_bytes = int(snap.nbytes())
    log(f"set-up: {data.n} objects, index {ctx.build_s:.3f} s ({index.num_nodes()} nodes, "
        f"levels {[l.n for l in index.levels]}), snapshot {ctx.snapshot_s:.3f} s, "
        f"{ctx.index_bytes} B, OBJ {snap.obj_per_leaf}")
    del index

    # warm-up: the first batch builds the kernels on a checkout's first run;
    # then pool batches in order until the pool is done or warmup_seconds
    # have passed, so that the plan's widths are learned before the window
    driver.start(snap)
    driver.serve(0)
    warm = time.perf_counter()
    served = 1
    while served < driver.n_batches and time.perf_counter() - warm < float(cell.traffic["warmup_seconds"]):
        driver.serve(served)
        served += 1
    _sync(device)
    driver.reset()

    # the window: a closed loop over the pool, from the first dispatch to the
    # end of the last batch dispatched before ``seconds`` ran out, less the
    # harness's own bookkeeping between batches (the driver's record())
    before = launch_counts()
    start = time.perf_counter()
    ctx.setup_s = start - t0
    i = 0
    rec = 0.0
    while True:
        now = time.perf_counter()
        if i >= min_batches and now - start >= seconds:
            break
        b = i % driver.n_batches
        out = driver.serve(b)
        done = time.perf_counter()
        ctx.latencies_s.append(done - now)
        driver.record(b, out)
        rec = time.perf_counter() - done
        ctx.record_s += rec
        del out
        i += 1
    ctx.window_s = done - start - (ctx.record_s - rec)
    after = launch_counts()
    ctx.launches = {k: after[k] - before.get(k, 0) for k in after}
    ctx.batches = i
    ctx.counters = dict(driver.sums)
    ctx.queries = int(driver.sums["queries"])
    log(f"window: {i} batches, {ctx.queries} queries in {ctx.window_s:.6f} s, besides "
        f"{ctx.record_s:.6f} s recording results; warm-up {served} batches; launches {ctx.launches}")

    if trace:
        from wiskbench import profiling

        sums = dict(driver.sums)
        ctx.trace = profiling.profile_loop(driver, i, float(cell.traffic["trace_seconds"]), device)
        ctx.trace_counters = {k: driver.sums[k] - sums.get(k, 0) for k in driver.sums}
        log(f"traced: {ctx.trace_counters.get('batches', 0)} batches, window {ctx.trace.window_s:.6f} s, "
            f"busy {ctx.trace.busy_s:.6f} s, {ctx.trace.n_events} events")

    if torch.device(device).type == "cuda":
        ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    driver.stop()
    del snap
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    verdict = driver.check()
    log(f"check against the reference: {time.perf_counter() - t:.3f} s")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": bool(verdict["correct"]),
        "attempted": int(verdict["attempted"]),
        "failed": int(verdict["failed"]),
        "metrics": metrics,
        "device": device_info(device, cell.chips, ctx),
    }
    if trace:
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = verdict["checks"]
    return result


def device_info(device: str, chips: int, ctx: Context) -> Dict[str, Any]:
    import torch

    cuda = torch.device(device).type == "cuda"
    info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": chips,
        "memory_peak_bytes": ctx.memory_peak_bytes,
    }
    if ctx.trace is not None:
        info["busy_s"] = ctx.trace.busy_s
        info["window_s"] = ctx.trace.window_s
    return info


def banned_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is one the port may not load."""
    return sorted({name for name in modules if name.split(".")[0] in BANNED})


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {name}: {c['value']} (limit {c['limit']})" for name, c in checks.items()]


def parse_args(argv: Optional[List[str]]):
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the GPU.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]], t0: float) -> int:
    import sys

    args = parse_args(argv)
    cell = Cell.from_spec(load_json(ROOT / "BENCHMARK.json"), args.workload)
    err = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        err(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0, log=err)
    found = banned_modules(list(sys.modules))
    if found:
        err(f"modules the benchmark's process may not load were loaded: {found}")
        return 3
    for line in check_lines(result["checks"]):
        err(line)
    print(json.dumps(result), flush=True)
    return 0
