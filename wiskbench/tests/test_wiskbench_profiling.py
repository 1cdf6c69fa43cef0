"""The trace reader on a Chrome trace of known intervals, and the readers of
the device metrics over it."""
import json
from types import SimpleNamespace

import pytest

from wiskbench import harness
from wiskbench.profiling import WINDOW, kernel_base, read_chrome_trace


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


@pytest.fixture
def trace(tmp_path):
    events = [
        _ev(WINDOW, "user_annotation", 1000, 1000),
        _ev("aten::nonzero", "cpu_op", 1050, 100),
        _ev("cudaMemcpyAsync", "cuda_runtime", 1300, 300),
        _ev("void fused_verify_slot_kernel<true>(Bank)", "kernel", 1100, 100, tid=7),
        _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1400, 200, tid=7),
        _ev("(anonymous namespace)::frontier_level_kernel(Level)", "kernel", 1150, 150, tid=7),
        _ev("Memset (Device)", "gpu_memset", 1900, 200, tid=7),  # half outside the window
        _ev("void other(int)", "kernel", 500, 100, tid=7),  # wholly outside
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return read_chrome_trace(str(path))


def test_busy_window_and_gaps(trace):
    assert trace.window_s == pytest.approx(1000e-6)
    # [1100, 1300) and [1400, 1600) and [1900, 2000)
    assert trace.busy_s == pytest.approx(500e-6)
    gaps = dict(trace.gaps)
    assert gaps["host: aten::nonzero"] == pytest.approx(100e-6)  # [1000, 1100)
    assert gaps["host: cudaMemcpyAsync"] == pytest.approx(100e-6)  # [1300, 1400)
    assert gaps["host: between operations"] == pytest.approx(300e-6)  # [1600, 1900)
    b = trace.breakdown()
    assert b["device_ops"][0][0].startswith("Memcpy DtoH") and len(b["device_ops"]) == 4


def test_kernel_base():
    assert kernel_base("void fused_verify_slot_kernel<true>(Bank)") == "fused_verify_slot_kernel"
    assert kernel_base("(anonymous namespace)::frontier_level_kernel(Level)") == "frontier_level_kernel"
    assert kernel_base("void ns::k<1, 2>(int)") == "k"


def test_device_metric_readers(trace):
    ctx = SimpleNamespace(trace=trace, trace_counters={"batches": 2, "queries": 10, "verified": 100,
                                                       "results": 20},
                          config={"data": {"max_kw": 5}}, traffic={"n_keywords": 5})
    idle = harness.load_module("metrics", "device_idle_pct.skr").read(ctx)
    assert idle == pytest.approx(50.0)
    d2h = harness.load_module("metrics", "d2h_ms_per_batch.skr").read(ctx)
    assert d2h == pytest.approx(0.1)
    roof = harness.load_module("metrics", "fused_verify_roofline").read(ctx)
    need = 100 * 28 + 20 * 4 + 10 * 36
    assert roof == pytest.approx(100 * need / 3.35e12 / 100e-6)
