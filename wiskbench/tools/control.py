"""The control's readings for one cell: the reference at a lower precision
put in the program's place (``reference/control.py``), judged by the cell's
own check.

    python3 wiskbench/tools/control.py --workload osm1m-str.skr-mix \
        --seeds 101 102 103 [--precision bf16|f16] [--batches N]

For each seed it makes the cell's objects and pool as a run does, serves
``--batches`` pool batches (default: the whole pool once) through the
stand-in, records them as the window does and prints the check's numbers.
It loads no part of the program and needs no GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def readings(cell, seed: int, precision: str, batches=None) -> dict:
    from wiskbench import harness

    data = harness.make_objects(cell.config, seed)
    driver = harness.load_module("drivers", cell.traffic["kind"]).Driver(
        cell.traffic, cell.config, data, seed)
    serve = driver.control(precision)
    for b in range(batches or driver.n_batches):
        driver.record(b % driver.n_batches, serve(b % driver.n_batches))
    return driver.check()


def main() -> None:
    from wiskbench import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--batches", type=int, default=None)
    a = p.parse_args()
    cell = harness.Cell.from_spec(harness.load_json(ROOT / "BENCHMARK.json"), a.workload)
    for seed in a.seeds:
        t = time.perf_counter()
        v = readings(cell, seed, a.precision, a.batches)
        print(json.dumps({"workload": a.workload, "seed": seed, "precision": a.precision,
                          "correct": v["correct"], "attempted": v["attempted"], "checks": v["checks"],
                          "seconds": round(time.perf_counter() - t, 3)}), flush=True)


if __name__ == "__main__":
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + sys.path[1:]
    main()
