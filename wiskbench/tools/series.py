"""Runs of one cell, one process each, and the spread of each metric.

    python3 wiskbench/tools/series.py --workload <cell> --seeds 11 12 13 \
        [--trace 0|1] [--seconds S] [--out <file>.jsonl]

Each seed is one ``wiskbench/run.py`` process, run one after another on
this machine's GPU. Every run's result line, exit code, wall seconds and
the end of its standard error go to ``--out`` (one JSON object a line);
the summary gives each metric's values, median and spread, the distance
between the first and third quartiles (``statistics.quantiles(n=4)``) as a
share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=1200)
    a = p.parse_args()
    seconds = a.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    runs = []
    for seed in a.seeds:
        cmd = [sys.executable, "wiskbench/run.py", "--workload", a.workload, "--seed", str(seed),
               "--seconds", str(seconds), "--trace", str(a.trace)]
        t = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=a.timeout)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", e.stderr or ""
            out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
        wall = time.perf_counter() - t
        lines = out.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = {"workload": a.workload, "seed": seed, "trace": a.trace, "seconds": seconds, "rc": rc,
               "wall_s": wall, "result": result, "stderr_tail": err[-3000:]}
        runs.append(rec)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        brief = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": rc, "wall_s": round(wall, 3),
                          "correct": (result or {}).get("correct"),
                          "failed": (result or {}).get("failed"), "metrics": brief,
                          "checks": (result or {}).get("checks")}), flush=True)
        if rc != 0 or result is None:
            print(err[-3000:], flush=True)
    names = sorted({k for r in runs if r["result"] for k in r["result"]["metrics"]})
    for name in names:
        vals = [r["result"]["metrics"][name]["value"] for r in runs
                if r["result"] and name in r["result"]["metrics"]]
        print(json.dumps({"metric": name, "values": vals, "median": statistics.median(vals),
                          "spread": spread(vals)}), flush=True)


if __name__ == "__main__":
    main()
