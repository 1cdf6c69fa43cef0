"""Dry run: trace every (arch x shape x mesh) cell on ``meta`` tensors -- the
port's counterpart of the JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each cell for 512 placeholder TPU devices
and reads XLA's memory and cost analyses and its HLO's collectives. The
port runs one rank's step of the cell on an abstract mesh
(``launch/mesh.py:make_abstract_mesh``): every tensor is ``meta``, so
nothing is allocated, and every op still runs through the dispatcher. A
cell records:

* ``memory.argument_bytes`` -- this rank's arguments as the port places
  them: the parameters, batch and cache of a serving step, the
  parameters, optimizer state, step and batch of a ``train`` step;
  ``memory.rules_argument_bytes`` -- the same leaves laid out wholly by the
  sharding rules (the reference's layout), counted from the whole leaves'
  logical names. Every family is placed by the rules
  (``train/step.py:Steps.placement``), so the two are equal: the second
  holds the first to the reference's layout;
  ``memory.peak_live_bytes`` -- the step's own allocations at their peak;
* ``cost`` and ``op_census`` -- ``roofline/op_stats.py`` over the step
  (matmul flops, bytes every op reads and writes, aten calls);
* ``collective_bytes_per_device`` / ``collective_counts`` /
  ``collective_total_per_device`` -- the collective census by operation
  (the reference's keys: result bytes per device), and
  ``collective_bytes_by_axis`` / ``collective_counts_by_axis``;
* ``fits`` -- each byte count against one H100's memory, and
  ``with_peak_live_bytes``: the arguments as placed plus the step's peak,
  an overstatement (eager ops keep intermediates a fused step would not),
  which for a ``train`` step is what decides whether it runs.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-moe-a2.7b --shape prefill_32k
  python -m repro_torch.launch.dryrun --arch wisk --shape serve --mesh pod=2,data=32,model=8
  python -m repro_torch.launch.dryrun --all [--out DIR] [--jobs N]

The default meshes are ``data=32,model=8`` (256 H100s, ``model`` inside one
8-GPU NVLink node) and ``pod=2,data=32,model=8`` (512); the reference's
``pod16x16`` is ``--mesh data=16,model=16``. ``--all`` runs each cell in a
subprocess, on both default meshes. A ``train_4k`` cell traces one
``train_step`` (the forward, the ``remat`` recompute, the backward with its
collectives, the gradient reductions and the optimizer) outside
``torch.no_grad()``. A batch that does not split over the data ranks is
recorded as skipped, as the reference's ``jit`` raises on it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import torch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
DEFAULT_MESHES = ("data=32,model=8", "pod=2,data=32,model=8")
WISK_SHAPES = ("serve", "serve2")
# one H100's memory where no card is present: torch.cuda.get_device_properties(0)
# .total_memory as chip_smoke.py read it on an NVIDIA H100 80GB HBM3
H100_MEMORY_BYTES = 85_017_493_504
H100_MEMORY_SOURCE = ("torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 "
                      "80GB HBM3, read by chip_smoke.py")


def parse_mesh(text: str) -> Dict[str, int]:
    """``"pod=2,data=32,model=8"`` -> ``{"pod": 2, "data": 32, "model": 8}``."""
    sizes = {}
    for part in text.split(","):
        name, n = part.split("=")
        sizes[name.strip()] = int(n)
    return sizes


def mesh_name(sizes: Dict[str, int]) -> str:
    return "x".join(f"{k}{v}" for k, v in sizes.items())


def device_memory() -> Dict[str, object]:
    """One card's memory: the card's own where one is present, else the
    value read on an H100, with its source."""
    if torch.cuda.is_available():
        return dict(bytes=int(torch.cuda.get_device_properties(0).total_memory),
                    source=f"torch.cuda.get_device_properties(0): {torch.cuda.get_device_name(0)}")
    return dict(bytes=H100_MEMORY_BYTES, source=H100_MEMORY_SOURCE)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _rules_bytes(tree, specs, mesh, rules) -> int:
    """Bytes of ``tree``'s tensors (a flat dict) laid out by ``rules`` on
    ``mesh``, each by its logical names in ``specs``."""
    from ..sharding.rules import named_sharding

    total = 0
    for name, t in tree.items():
        shape = named_sharding(mesh, specs[name], rules).shard_shape(t.shape)
        total += math.prod(shape) * t.element_size()
    return total


def _collectives(rec: Dict, by_axis: Dict, counts_by_axis: Dict) -> None:
    by_op = {c: 0 for c in COLLECTIVES}
    calls = {c: 0 for c in COLLECTIVES}
    for axis, ops in by_axis.items():
        for op, n in ops.items():
            by_op[op] += n
            calls[op] += counts_by_axis[axis][op]
    rec["collective_bytes_per_device"] = by_op
    rec["collective_counts"] = calls
    rec["collective_total_per_device"] = int(sum(by_op.values()))
    rec["collective_bytes_by_axis"] = by_axis
    rec["collective_counts_by_axis"] = counts_by_axis


def _named(tree, prefix: str = "") -> Dict:
    """A tree of dicts and named tuples as a flat dict by dotted name."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix[:-1]: tree}
    return {n: v for k, t in items for n, v in _named(t, f"{prefix}{k}.").items()}


def _lm_cell(rec: Dict, cfg, kind: str, seq: int, batch: int, mesh) -> None:
    """Trace one rank's train, prefill or decode step of ``cfg`` on ``mesh``."""
    from ..models.layers import split_params
    from ..models.model import build_model
    from ..optim.optimizers import get_optimizer
    from ..roofline.op_stats import OpStats
    from ..sharding.rules import dp_axes
    from ..train.step import OPT_SPECS, build_steps
    from ..tree import leaves
    from .mesh import collective_census

    steps = build_steps(cfg, mesh=mesh)
    n_dp = math.prod(mesh.axis(a).size for a in dp_axes(mesh))
    whole_values, whole_specs = split_params(build_model(cfg).init_tree(torch.Generator(),
                                                                          "meta"))
    if kind == "train":  # the whole state: parameters, optimizer state, step
        whole_values = dict(params=whole_values,
                            opt=get_optimizer(cfg.optimizer)[0](whole_values),
                            step=_meta((), torch.int32))
        whole_specs = dict(params=whole_specs, opt=OPT_SPECS[cfg.optimizer](whole_specs),
                           step=())
    rules_bytes = _rules_bytes(_named(whole_values), _named(whole_specs), mesh, steps.rules)
    if kind in ("train", "prefill"):
        if batch % n_dp:
            rec["skipped"] = (f"batch {batch} does not split over the {n_dp} data ranks "
                              f"(a jit with the rules' batch sharding raises the same)")
            return
        sds, specs = steps.batch_spec(kind, seq, batch)
        inputs = {k: _meta(s.shape, s.dtype) for k, s in sds.items()}
        local = steps.local(inputs, specs)
        rules_bytes += _rules_bytes(inputs, specs, mesh, steps.rules)
    if kind == "train":
        state = steps.init_state(torch.Generator())
        args = _nbytes(leaves(state))
        with collective_census() as census, OpStats() as stats:
            _, metrics = steps.train_step(state, inputs)
        out = metrics["loss"]
    elif kind == "prefill":
        params = steps.bundle.init(torch.Generator(), "meta")
        args = _nbytes(params.parameters())
        with torch.no_grad(), collective_census() as census, OpStats() as stats:
            out = steps.prefill_step(params, inputs)
    else:
        params = steps.bundle.init(torch.Generator(), "meta")
        args = _nbytes(params.parameters())
        long_ctx = batch < n_dp
        rec["long_ctx"] = long_ctx
        sds, specs = steps.cache_spec(batch, seq, long_ctx)
        cache = steps.init_cache(batch, seq, long_ctx)
        tok_specs = dict(tokens=(None, None) if long_ctx else ("batch", None))
        tokens = dict(tokens=_meta((batch, 1), torch.int32))
        pos = _meta((), torch.int32)
        local = dict(cache, **steps.local(tokens, tok_specs), pos=pos)
        with torch.no_grad(), collective_census() as census, OpStats() as stats:
            out, _ = steps.decode_step(params, cache, tokens["tokens"], pos, long_ctx)
        whole_cache = {k: _meta(s.shape, s.dtype) for k, s in sds.items()}
        rules_bytes += _rules_bytes(whole_cache, specs, mesh, steps.rules)
        rules_bytes += _rules_bytes(tokens, tok_specs, mesh, steps.rules) + 4
    rec["output_shape"] = list(out.shape)
    rec["memory"] = dict(argument_bytes=args + _nbytes(local.values()),
                         rules_argument_bytes=rules_bytes,
                         peak_live_bytes=stats.peak_live_bytes)
    rec["op_census"] = stats.as_dict()
    _collectives(rec, census.bytes, census.counts)


def run_cell(arch: str, shape: str, mesh: str = DEFAULT_MESHES[0], out_dir: Optional[Path] = None,
             seq: Optional[int] = None, batch: Optional[int] = None, cfg=None) -> Dict:
    """Trace one cell and return its record (written to ``out_dir`` when
    given). ``seq``, ``batch`` and ``cfg`` override the shape's sequence
    length and global batch and the arch's config (``cfg`` of ``wisk`` is
    a ``WiskServeConfig``)."""
    from ..configs import get_config
    from ..configs.base import SHAPES, applicable_shapes
    from .mesh import make_abstract_mesh

    sizes = parse_mesh(mesh) if isinstance(mesh, str) else dict(mesh)
    amesh = make_abstract_mesh(**sizes)
    rec = dict(arch=arch, shape=shape, mesh=mesh_name(sizes), devices=math.prod(sizes.values()))
    t0 = time.perf_counter()
    if arch == "wisk":
        from .flat_legacy import trace_wisk_serve

        if shape not in WISK_SHAPES:
            raise ValueError(f"wisk's shapes are {WISK_SHAPES}, not {shape!r}")
        r = trace_wisk_serve(amesh, cfg or get_config("wisk"), two_stage=(shape == "serve2"))
        rec["kind"] = "serve"
        # the flat step places every operand by the rules
        rec["memory"] = dict(argument_bytes=r["argument_bytes"],
                             rules_argument_bytes=r["argument_bytes"],
                             peak_live_bytes=r["op_census"]["peak_live_bytes"])
        rec["op_census"] = r["op_census"]
        _collectives(rec, r["collective_bytes_by_axis"], r["collective_counts_by_axis"])
    else:
        cfg = cfg or get_config(arch)
        if shape not in applicable_shapes(cfg):
            rec["skipped"] = f"shape {shape} not applicable to {arch} (see DESIGN.md)"
        else:
            seq_d, batch_d, kind = SHAPES[shape]
            seq, batch = seq or seq_d, batch or batch_d
            rec.update(kind=kind, seq=seq, batch=batch, n_layers=cfg.n_layers)
            _lm_cell(rec, cfg, kind, seq, batch, amesh)
    if "op_census" in rec:
        rec["cost"] = {"flops": float(rec["op_census"]["flops"]),
                       "bytes accessed": float(rec["op_census"]["bytes"])}
        mem = device_memory()
        rec["fits"] = dict(argument_bytes=rec["memory"]["argument_bytes"] <= mem["bytes"],
                           rules_argument_bytes=rec["memory"]["rules_argument_bytes"] <= mem["bytes"],
                           with_peak_live_bytes=rec["memory"]["argument_bytes"]
                           + rec["memory"]["peak_live_bytes"] <= mem["bytes"],
                           device_memory_bytes=mem["bytes"], source=mem["source"])
    rec["trace_s"] = round(time.perf_counter() - t0, 3)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}_{shape}_{rec['mesh']}.json").write_text(json.dumps(rec, indent=1))
    return rec


def all_cells():
    """Every (arch, shape) of the dry run: each arch's applicable shapes,
    and wisk's two."""
    from ..configs import ARCH_IDS, get_config
    from ..configs.base import applicable_shapes

    cells = [(a, s) for a in ARCH_IDS for s in applicable_shapes(get_config(a))]
    return cells + [("wisk", s) for s in WISK_SHAPES]


def _run_sub(arch: str, shape: str, mesh: str, out_dir: Path):
    """One cell in a subprocess; its seconds written into its record."""
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join([src] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh, "--out", str(out_dir)]
    t = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env)
    seconds = time.perf_counter() - t
    f = out_dir / f"{arch}_{shape}_{mesh_name(parse_mesh(mesh))}.json"
    if r.returncode == 0:
        rec = json.loads(f.read_text())
        rec["seconds"] = round(seconds, 3)
        f.write_text(json.dumps(rec, indent=1))
    return arch, shape, mesh, r, seconds


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=DEFAULT_MESHES[0])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1, help="cells traced at once with --all")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()
    out_dir = Path(args.out)

    if args.all:
        jobs = [(a, s, m) for m in DEFAULT_MESHES for a, s in all_cells()]
        failures = []
        with ThreadPoolExecutor(max(1, args.jobs)) as pool:
            for a, s, m, r, sec in pool.map(lambda c: _run_sub(*c, out_dir), jobs):
                if r.returncode != 0:
                    failures.append((a, s, m, r.stdout[-2000:] + r.stderr[-2000:]))
                    print("FAIL", a, s, m, flush=True)
                else:
                    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else "ok"
                    print(f"{sec:.1f} s", last, flush=True)
        print(f"\n{len(failures)} failures of {len(jobs)} cells")
        for a, s, m, text in failures:
            print("=" * 80, "\nFAILED:", a, s, m, "\n", text[-1500:])
        return 1 if failures else 0

    try:
        rec = run_cell(args.arch, args.shape, args.mesh, out_dir)
    except Exception:
        traceback.print_exc()
        return 1
    if "skipped" in rec:
        print("SKIP:", rec["skipped"])
    else:
        print("memory:", rec["memory"], "fits:", {k: rec["fits"][k] for k in
                                                   ("argument_bytes", "rules_argument_bytes",
                                                   "with_peak_live_bytes")})
        print("cost: flops=%.3e bytes=%.3e" % (rec["cost"]["flops"], rec["cost"]["bytes accessed"]))
        print("collectives (B/device):", rec["collective_bytes_by_axis"])
        if args.arch != "wisk":
            from ..roofline.analysis import roofline_from_record

            row = roofline_from_record(rec)
            print("roofline (ms a step and rank): compute %.3f memory %.3f collective %.3f, "
                  "bound: %s" % (row.compute_s * 1e3, row.memory_s * 1e3,
                                 row.collective_s * 1e3, row.bottleneck))
    print("PASS", f"{args.arch}_{args.shape}_{rec['mesh']}.json", f"{rec['trace_s']} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
