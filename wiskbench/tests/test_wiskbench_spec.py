"""``BENCHMARK.json`` and the folder it names: every piece found by name,
the names and limits the benchmark's contract sets, and the import rule
(no module under ``wiskbench/`` loads JAX or the JAX package, and the
reference and generators load nothing of the program)."""
import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "wiskbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"]
    assert SPEC["paths"] == ["wiskbench"] and SPEC["command"] == ["python3", "wiskbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_piece_is_a_file_found_by_name():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("wiskbench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and (BENCH / "indexes" / f"{body['index']['kind']}.py").is_file()
        assert set(c["reduced"]) <= set(body["data"]) | set(body["reduced"])
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for w in SPEC["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                      "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_enough(cell):
    from wiskbench.harness import Cell

    c = Cell.from_spec(SPEC, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_import_rule(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if path.parent.name in ("reference", "gen"):
        assert "repro_torch" not in tops, tops


def test_banned_modules_compares_whole_names():
    from wiskbench.harness import banned_modules

    assert banned_modules(["repro_torch", "repro_torch.serve", "numpy"]) == []
    assert banned_modules(["repro", "repro.core", "jax._src", "flax"]) == ["flax", "jax._src", "repro",
                                                                          "repro.core"]
