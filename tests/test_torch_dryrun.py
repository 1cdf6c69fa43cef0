"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.roofline``) against the JAX package's, on the CPU.

* ``run_cell`` traces every arch's applicable serving shapes at
  ``reduced()`` (small ``seq`` / ``batch``, mesh ``data=2,model=2``) on
  meta tensors, allocating nothing, and every record has the reference's
  keys (and the port's ``rules_argument_bytes``, ``op_census`` and
  ``fits``); ``train_4k`` cells are traced (``fits`` and a roofline row);
  a batch smaller than the data ranks takes the long-context layout and an
  uneven one is skipped; every cell's arguments as placed are the rules'
  bytes;
* ``param_counts`` and ``model_flops`` equal the reference's for every
  arch and shape, and ``descent_bytes``, ``filter_level_bytes``,
  ``verify_bytes`` and ``remap_bytes`` give the reference's integers over a
  grid of arguments;
* ``OpStats`` counts 2·m·n·k flops for a plain product, and the bytes read
  and written;
* ``trace_wisk_serve`` at ``(data=2, model=4)`` gives the argument bytes
  per device of the reference's ``lower_wisk_serve(...).compile()``
  (``memory_analysis().argument_size_in_bytes``) and the collective bytes
  of ``parse_collective_bytes`` of its HLO, in both modes (the reference on
  a forced 8-device host platform, in one subprocess);
* ``build_steps(cfg, device="meta")`` gives deepseek-v3-671b's published
  state (61 layers, 671 B parameters) on meta, drawing nothing, and
  ``train_step`` runs on an abstract mesh of ranks: the rank's state
  shapes (the rules' blocks), the backward's reduce-scatters in its
  census, one for each ZeRO-3 gather.
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.roofline import analysis as janalysis, descent_bytes as jdescent  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config  # noqa: E402
from repro_torch.configs.wisk import WiskServeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.flat_legacy import trace_wisk_serve  # noqa: E402
from repro_torch.launch.mesh import collective_census, make_abstract_mesh  # noqa: E402
from repro_torch.roofline import analysis, descent_bytes  # noqa: E402
from repro_torch.roofline.op_stats import OpStats  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESH = "data=2,model=2"
CELL = dict(seq=32, batch=4)
WISK = WiskServeConfig(n_queries=64, n_nodes=256, vocab=256)
REFERENCE_KEYS = ("arch", "shape", "mesh", "devices", "kind", "memory", "cost",
                  "collective_bytes_per_device", "collective_counts",
                  "collective_total_per_device")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_FORCED = r"""
import json, sys
import jax

# the backend starts before repro.launch.dryrun, whose import asks for 512 devices
assert len(jax.devices()) == 8, jax.devices()
from repro.configs.wisk import WiskServeConfig
from repro.launch.dryrun import parse_collective_bytes
from repro.launch.flat_legacy import lower_wisk_serve

mesh = jax.make_mesh((2, 4), ("data", "model"))
cfg = WiskServeConfig(n_queries=64, n_nodes=256, vocab=256)
out = {}
for two in (False, True):
    c = lower_wisk_serve(mesh, cfg, two_stage=two).compile()
    coll, counts = parse_collective_bytes(c.as_text())
    out[str(two)] = dict(args=int(c.memory_analysis().argument_size_in_bytes), coll=coll)
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def forced_reference():
    """The reference's flat step lowered and compiled on a forced 8-device
    host platform, in a subprocess started with the module's first test."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} --xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.Popen([sys.executable, "-c", _FORCED], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _serving_cells():
    return [(a, s) for a in ARCH_IDS for s in applicable_shapes(get_config(a))
            if SHAPES[s][2] != "train"]


@pytest.mark.parametrize("arch,shape", _serving_cells())
def test_run_cell_traces_every_serving_cell(arch, shape, tmp_path):
    cfg = get_config(arch).reduced()
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    rec = dryrun.run_cell(arch, shape, MESH, tmp_path, cfg=cfg, **CELL)
    assert "skipped" not in rec, rec.get("skipped")
    for k in REFERENCE_KEYS:
        assert k in rec, k
    assert set(rec["collective_bytes_per_device"]) == set(dryrun.COLLECTIVES)
    assert rec["devices"] == 4 and rec["mesh"] == "data2xmodel2"
    assert rec["kind"] == SHAPES[shape][2]
    mem = rec["memory"]
    assert 0 < mem["rules_argument_bytes"] == mem["argument_bytes"]  # placed by the rules
    assert rec["op_census"]["flops"] > 0 and rec["cost"]["flops"] == rec["op_census"]["flops"]
    assert rec["fits"]["argument_bytes"] and rec["fits"]["device_memory_bytes"] > 0
    assert rec["output_shape"] == [CELL["batch"] // 2, 1, cfg.vocab]
    # every family's weights are gathered over data and its layers sum over model
    assert rec["collective_total_per_device"] > 0
    assert set(rec["collective_bytes_by_axis"]) == {"data", "model"}
    saved = json.loads((tmp_path / f"{arch}_{shape}_data2xmodel2.json").read_text())
    assert saved == rec
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before
    row = analysis.roofline_from_record(rec, cfg)
    assert row.compute_s > 0 and row.memory_s > 0 and row.collective_s > 0


def test_a_train_cell_fits_only_with_its_peak_beside_its_state(monkeypatch, tmp_path):
    """``fits.with_peak_live_bytes`` adds the step's peak to the arguments:
    a card that holds the state but not the step's peak beside it fails it."""
    cfg = get_config("tinyllama-1.1b").reduced()
    rec = dryrun.run_cell("tinyllama-1.1b", "train_4k", MESH, tmp_path, cfg=cfg, **CELL)
    mem = rec["memory"]
    assert rec["fits"]["with_peak_live_bytes"] and mem["peak_live_bytes"] > 0
    need = mem["argument_bytes"] + mem["peak_live_bytes"]
    monkeypatch.setattr(dryrun, "device_memory", lambda: dict(bytes=need - 1, source="test"))
    rec = dryrun.run_cell("tinyllama-1.1b", "train_4k", MESH, tmp_path, cfg=cfg, **CELL)
    assert rec["fits"]["argument_bytes"] and not rec["fits"]["with_peak_live_bytes"]
    monkeypatch.setattr(dryrun, "device_memory", lambda: dict(bytes=need, source="test"))
    rec = dryrun.run_cell("tinyllama-1.1b", "train_4k", MESH, tmp_path, cfg=cfg, **CELL)
    assert rec["fits"]["with_peak_live_bytes"]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b"])
def test_train_cells_are_traced_and_small_batches_take_long_context(arch, tmp_path):
    cfg = get_config(arch).reduced()
    rec = dryrun.run_cell(arch, "train_4k", MESH, tmp_path, cfg=cfg, **CELL)
    assert "skipped" not in rec, rec.get("skipped")
    assert rec["kind"] == "train" and rec["output_shape"] == []
    assert rec["fits"]["argument_bytes"] and rec["fits"]["rules_argument_bytes"]
    mem = rec["memory"]
    assert 0 < mem["rules_argument_bytes"] == mem["argument_bytes"]
    # the loss and the global norm are summed over every rank
    assert rec["collective_counts_by_axis"]["everyone"]["all-reduce"] > 0
    row = analysis.roofline_from_record(rec, cfg)
    assert row.compute_s > 0 and row.memory_s > 0 and row.collective_s > 0
    assert row.model_flops == analysis.model_flops(cfg, "train_4k")
    rec = dryrun.run_cell(arch, "train_4k", MESH, tmp_path, cfg=cfg, seq=32, batch=3)
    assert "does not split" in rec["skipped"]
    rec = dryrun.run_cell(arch, "decode_32k", MESH, tmp_path, cfg=get_config(arch).reduced(),
                          seq=32, batch=1)
    assert rec["long_ctx"] and rec["output_shape"][0] == 1
    rec = dryrun.run_cell(arch, "prefill_32k", MESH, tmp_path, cfg=get_config(arch).reduced(),
                          seq=32, batch=3)
    assert "does not split" in rec["skipped"]


def test_roofline_table_and_cli(tmp_path):
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    for shape in ("prefill_32k", "decode_32k"):
        dryrun.run_cell("qwen2-moe-a2.7b", shape, MESH, tmp_path, cfg=cfg, **CELL)
    rows = analysis.load_rows(str(tmp_path), "data2xmodel2")
    assert [r.shape for r in rows] == ["decode_32k", "prefill_32k"]
    table = analysis.to_markdown(rows)
    assert table.count("\n") == 4 and "qwen2-moe-a2.7b" in table
    # the bytes a rank: as placed equal to the rules' (every family's layout)
    mem = analysis.memory_markdown(str(tmp_path), "data2xmodel2")
    assert mem.count("\n") == 4
    assert all(row.split(" | ")[4] == "True" for row in mem.splitlines()[2:])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "wisk",
                        "--shape", "serve2", "--mesh", "data=2,model=4", "--out", str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads((tmp_path / "wisk_serve2_data2xmodel4.json").read_text())
    assert rec["kind"] == "serve" and rec["collective_bytes_per_device"]["all-reduce"] > 0
    assert analysis.roofline_from_record(rec) is None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert analysis.param_counts(cfg) == janalysis.param_counts(jcfg)
    for shape in SHAPES:
        assert analysis.model_flops(cfg, shape) == janalysis.model_flops(jcfg, shape)
        for chips in (256, 512):
            assert (analysis.analytic_hbm_bytes(cfg, shape, chips)
                    == janalysis.analytic_hbm_bytes(jcfg, shape, chips))


def test_descent_bytes_equal_the_reference():
    for m, w, nw, wp, dsz in itertools.product((1, 37, 1024), (8, 7832), (8, 256), (0, 3),
                                               ((0, 0), (61, 17))):
        for narrow in (False, True):
            kw = dict(narrow=narrow, packed_words=wp, dict_sizes=dsz)
            assert (descent_bytes.filter_level_bytes(m, w, nw, **kw)
                    == jdescent.filter_level_bytes(m, w, nw, **kw))
    for m, t, obj, nw, k, bm, wl in itertools.product((1, 37, 1024), (1, 32), (128, 512),
                                                      (8, 256), (11, 7832), (1, 8), (0, 4)):
        assert descent_bytes.remap_bytes(m, t, wl) == jdescent.remap_bytes(m, t, wl)
        for variant in ("unfused", "vmem", "prefetch"):
            assert (descent_bytes.verify_bytes(m, t, obj, nw, k, variant, bm, wl)
                    == jdescent.verify_bytes(m, t, obj, nw, k, variant, bm, wl))
    with pytest.raises(ValueError):
        descent_bytes.verify_bytes(1, 1, 1, 1, 1, "other")
    for narrow, t in itertools.product((False, True), (0, 32)):
        kw = dict(narrow=narrow, packed_words=3, dict_sizes=[(5, 7)] * 5 if narrow else (),
                  t=t, obj_per_leaf=128, n_leaves=7832, verify_variant="prefetch",
                  compact_words=4)
        got = descent_bytes.descent_bytes(1024, [4, 19, 131, 991, 7832], 256, **kw)
        want = jdescent.descent_bytes(1024, [4, 19, 131, 991, 7832], 256, **kw)
        assert (got.filter_bytes, got.verify_bytes, got.per_level) == (
            want.filter_bytes, want.verify_bytes, want.per_level)
        assert got.total_ms == got.total / analysis.HBM_BW * 1e3
    legacy = descent_bytes.descent_bytes(64, [8, 64], 256)
    narrow = descent_bytes.descent_bytes(64, [8, 64], 256, narrow=True, packed_words=3)
    assert descent_bytes.compare(legacy, narrow)["ratio"] == legacy.total / narrow.total


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_op_stats_counts_a_plain_product(device):
    m, n, k = 48, 40, 24
    a = torch.ones((m, k), device=device)
    b = torch.ones((k, n), device=device)
    with OpStats() as st:
        c = a @ b
        d = c.t()  # a view: no bytes
        e = torch.relu(c)
    assert st.flops == 2 * m * n * k
    assert st.bytes == 4 * (m * k + k * n + m * n) + 4 * 2 * m * n
    assert st.calls == 3 and st.peak_live_bytes == 2 * 4 * m * n
    assert st.flops_by_op() == {"aten.mm": 2 * m * n * k}
    del d, e


def test_trace_wisk_serve_equals_xla(forced_reference):
    out, err = forced_reference.communicate(timeout=240)
    assert forced_reference.returncode == 0, err[-4000:]
    want = json.loads(out.strip().splitlines()[-1])
    mesh = make_abstract_mesh(data=2, model=4)
    for two in (False, True):
        got = trace_wisk_serve(mesh, WISK, two_stage=two)
        assert got["argument_bytes"] == want[str(two)]["args"]
        by_op = {}
        for ops in got["collective_bytes_by_axis"].values():
            for op, n in ops.items():
                by_op[op] = by_op.get(op, 0) + n
        assert {k: v for k, v in want[str(two)]["coll"].items() if v} == by_op


def test_train_step_over_an_abstract_mesh():
    """``train_step`` on a mesh of ranks runs on the abstract mesh: the
    state keeps the rank's blocks by the rules, the census has the
    backward's reduce-scatter of every weight gathered over data (a layer's
    attention, router, expert stacks and shared experts; the embedding and
    the head)."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    steps = build_steps(cfg, mesh=make_abstract_mesh(data=2, model=2))
    state = steps.init_state(torch.Generator())
    shapes = [tuple(p.shape) for p in state["params"].parameters()]
    batch = dict(tokens=torch.empty((4, 16), dtype=torch.int32, device="meta"))
    with collective_census() as census:
        state, metrics = steps.train_step(state, batch)
    assert [tuple(p.shape) for p in state["params"].parameters()] == shapes
    moe = state["params"].moe_blocks.moe
    E, d, f = 16, cfg.d_model, cfg.d_expert
    assert tuple(moe.w_gate.shape) == (cfg.n_layers, E // 2, d // 2, f)
    assert tuple(moe.w_down.shape) == (cfg.n_layers, E // 2, f, d // 2)
    attn = state["params"].moe_blocks.attn
    H, hd = cfg.n_heads, cfg.head_dim
    assert tuple(attn.wq.shape) == (cfg.n_layers, d // 2, H // 2, hd)
    assert tuple(attn.wk.shape) == (cfg.n_layers, d // 2, cfg.n_kv_heads, hd)
    assert tuple(state["params"].embed.table.shape) == (cfg.vocab // 2, d // 2)
    m, v = (getattr(state["opt"], k)["moe_blocks"]["moe"]["w_gate"] for k in ("m", "v"))
    assert tuple(m.shape) == tuple(v.shape) == tuple(moe.w_gate.shape)
    assert metrics["loss"].shape == () and int(state["step"].numel()) == 1
    gathered = census.bytes["data"]["all-gather"]
    # a layer: wq, wk, wv, wo, the router, three expert stacks, three shared
    assert census.counts["data"]["reduce-scatter"] == census.counts["data"]["all-gather"] == 11 * (
        cfg.n_layers) + 2
    # each reduce-scatter returns the rank's block: half of what its gather made
    assert census.bytes["data"]["reduce-scatter"] * 2 == gathered
    assert steps.rules["experts"] == "model" and steps.rules["batch"] == ("data",)


def test_meta_state_of_a_published_config_draws_nothing():
    cfg = get_config("deepseek-v3-671b")
    steps = build_steps(cfg, device="meta")
    state = steps.init_state(torch.Generator())
    params = list(state["params"].parameters())
    assert all(p.device.type == "meta" for p in params)
    n = sum(p.numel() for p in params)
    assert n > 6.5e11, n
    assert state["step"].device.type == "meta"
    moe = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=2)
    mesh = make_abstract_mesh(data=4, model=8)
    local = build_steps(moe, mesh=mesh).init_state(torch.Generator())["params"]
    assert tuple(local.moe_blocks.moe.w_gate.shape) == (2, 64 // 8, moe.d_model // 4,
                                                         moe.d_expert)
    assert np.isfinite(analysis.PEAK_FLOPS)
