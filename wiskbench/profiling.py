"""The traced stretch of a run: ``torch.profiler`` over a few batches of the
closed loop, read back from its Chrome trace.

On the device's timeline every kernel, copy and memset counts as busy; the
union of those intervals inside the stretch is ``busy_s`` and the stretch's
length ``window_s``. Each idle gap between them is labelled by the
innermost operation the host was in at the gap's middle (an ``aten`` op,
a CUDA runtime call, or none: Python between calls).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

WINDOW = "wiskbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def kernel_base(name: str) -> str:
    """A kernel's function name without return type, namespace, template
    arguments or parameters: ``void ns::foo_kernel<1>(Bank)`` -> ``foo_kernel``."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", s, maxsplit=1)[0].split("::")[-1].strip()


class Trace:
    """The device's events (name, category, start, duration in seconds)
    inside the profiled stretch, and the host's labels for its idle gaps."""

    def __init__(self, device: List[Tuple[str, str, float, float]], window: Tuple[float, float],
                 gaps: Dict[str, float], n_events: int) -> None:
        self.device = device
        self.window_s = window[1] - window[0]
        self.busy_s = _union(np.array([[s, s + d] for _, _, s, d in device]).reshape(-1, 2))
        self.gaps = gaps
        self.n_events = n_events

    def seconds(self, pred) -> float:
        return float(sum(d for name, cat, _, d in self.device if pred(name, cat)))

    def breakdown(self) -> Dict[str, List]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, _, d in self.device:
            by_name[name[:120]] += d
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def _union(iv: np.ndarray) -> float:
    """Total length of the union of [start, end) intervals."""
    merged = _merge(iv)
    return float((merged[:, 1] - merged[:, 0]).sum()) if merged.size else 0.0


def _merge(iv: np.ndarray) -> np.ndarray:
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stops = ends[np.r_[last[1:] - 1, len(iv) - 1]]
    return np.stack([starts, stops], 1)


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in complete if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the profiled stretch's annotation is missing from the trace")
    mark = marks[0]
    w0, w1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    device = []
    for e in complete:
        if e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 > s0:
                device.append((e["name"], e["cat"], s0 * 1e-6, (s1 - s0) * 1e-6))
    host = [e for e in complete if e.get("cat") in HOST_CATS and e.get("tid") == mark.get("tid")]
    gaps = _label_gaps(device, (w0 * 1e-6, w1 * 1e-6), host)
    return Trace(device, (w0 * 1e-6, w1 * 1e-6), gaps, len(complete))


def _label_gaps(device, window, host) -> Dict[str, float]:
    busy = _merge(np.array([[s, s + d] for _, _, s, d in device]).reshape(-1, 2))
    edges = np.concatenate([[window[0]], busy.reshape(-1), [window[1]]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    out: Dict[str, float] = defaultdict(float)
    if gaps.size == 0:
        return out
    hs = np.array([float(e["ts"]) * 1e-6 for e in host])
    he = hs + np.array([float(e["dur"]) * 1e-6 for e in host])
    order = np.argsort(hs, kind="stable")
    hs, he = hs[order], he[order]
    names = [host[i]["name"] for i in order]
    mids = gaps.mean(axis=1)
    pos = np.searchsorted(hs, mids, side="right") - 1
    for (g0, g1), m, p in zip(gaps, mids, pos):
        label = "host: between operations"
        # the latest-starting host event that still covers the middle is the
        # innermost; its ancestors start earlier
        for j in range(p, max(p - 64, -1), -1):
            if he[j] >= m:
                label = f"host: {names[j][:100]}"
                break
        out[label] += float(g1 - g0)
    return out


def profile_loop(driver, first: int, seconds: float, device: str) -> Trace:
    """Serve pool batches ``first, first + 1, ...`` under the profiler until
    ``seconds`` have passed (at least one batch), recording each like the
    window's, and read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                start = time.perf_counter()
                i = first
                while i == first or time.perf_counter() - start < seconds:
                    b = i % driver.n_batches
                    driver.record(b, driver.serve(b))
                    i += 1
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return read_chrome_trace(path)
