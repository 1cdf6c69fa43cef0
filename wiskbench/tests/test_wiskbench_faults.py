"""A run's check sees a broken timed path: each cell run on the CPU at a
small size (the look for a GPU skipped) with the port's front door broken
underneath comes out not correct; unbroken it comes out correct. Also the
command's refusal without a GPU, and a short cell run on the GPU (``cuda``).
"""
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch.launch import wisk_serve
from wiskbench import harness

CELLS = ["osm1m-str.skr-mix", "osm1m-wisk.skr-mix", "osm1m-str.knn-mix"]


def _front_door(name):
    return "serve_knn_batch" if name.endswith("knn-mix") else "serve_batch"


def half_batch(out):
    """Half of the batch left out: only the first half's rows come back."""
    m = len(out["ids"]) // 2
    return {k: (v[:m] if np.ndim(v) and len(v) == 2 * m else v) for k, v in out.items()}


def altered_answer(out):
    """One id of every answer replaced by another object's where it is made."""
    ids = out["ids"].copy()
    rows = np.flatnonzero((ids >= 0).any(1))
    first = np.argmax(ids[rows] >= 0, axis=1)
    ids[rows, first] = (ids[rows, first] + 1) % 1000
    return dict(out, ids=ids)


class Stale:
    """A step that returns its state unchanged: every batch after the first
    gets the first batch's answers."""

    def __init__(self):
        self.first = None

    def __call__(self, out):
        if self.first is None:
            self.first = out
        return self.first


FAULTS = {"half_batch": lambda: half_batch, "altered_answer": lambda: altered_answer, "stale": Stale}


def _run(cell, trace=False):
    # two batches at least, so that a stale answer can show
    r = harness.run_cell(cell, 2 ** 31 + 77, 0.5, trace, "cpu", time.perf_counter(),
                         log=lambda *_: None, min_batches=2)
    assert r["attempted"] >= 2 * cell.traffic["batch"]
    return r


@pytest.mark.parametrize("name", CELLS)
def test_unbroken_run_is_correct(small_cell, name):
    r = _run(small_cell(name))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_front_door_is_not_correct(small_cell, monkeypatch, name, fault):
    door = _front_door(name)
    real = getattr(wisk_serve, door)
    broken = FAULTS[fault]()
    monkeypatch.setattr(wisk_serve, door, lambda *a, **k: broken(real(*a, **k)))
    r = _run(small_cell(name))
    assert not r["correct"], r["checks"]


def test_traced_run_reports_the_layers_it_can_read_here(small_cell):
    r = _run(small_cell("osm1m-str.skr-mix"), trace=True)
    assert r["correct"] and "breakdown" in r
    assert list(r)[-1] == "checks"
    # no device on the CPU: the device metrics find nothing and are left out
    assert {"eq1_per_query.skr", "build_s", "snapshot_s", "index_device_gib",
            "skr_batch_p50_ms"} <= set(r["metrics"])
    assert not {"device_idle_pct.skr", "d2h_ms_per_batch.skr", "fused_verify_roofline"} & set(r["metrics"])


def test_command_refuses_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                           "osm1m-str.skr-mix", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""


@pytest.mark.cuda
def test_short_run_on_the_gpu():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                           "osm1m-str.skr-mix", "--seed", "5", "--seconds", "2", "--trace", "1"],
                          capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
