"""The benchmark's own tests: the harness, its generators, reference and
check on the CPU at small sizes (``python -m pytest wiskbench/tests``);
tests marked ``cuda`` run a cell on the GPU and skip elsewhere."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402

# BuildConfig overrides that keep build_wisk to seconds on the CPU
SMALL_BUILD = {
    "partition": {"max_clusters": 64, "n_steps": 20, "n_restarts": 2, "min_objects": 64,
                  "query_pad": 16, "max_split_batch": 8},
    "packing": {"epochs": 2, "max_label_queries": 8},
    "cdf_train_steps": 40,
    "use_itemsets": False,
}


def shrink(cell, n: int = 20_000, batch: int = 64, pool: int = 4):
    """A cell of BENCHMARK.json cut to a CPU's size: ``n`` objects, pools
    of ``pool`` batches of ``batch`` queries, a small build for WISK."""
    cell.config["data"]["n"] = n
    cell.config["serve"]["max_leaves"] = 256
    if cell.config["index"]["kind"] == "wisk_learned":
        cell.config["index"]["build"] = SMALL_BUILD
        cell.config["index"]["train"]["m"] = 64
    cell.traffic.update(batch=batch, pool_batches=pool, warmup_seconds=0.2, trace_seconds=0.1)
    return cell


@pytest.fixture
def small_cell():
    from wiskbench import harness

    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    return lambda name, **kw: shrink(harness.Cell.from_spec(spec, name), **kw)
