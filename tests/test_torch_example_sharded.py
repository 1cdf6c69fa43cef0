"""The port's multi-rank walkthrough (``examples/torch_serve_skr_sharded.py``)
under ``torchrun`` on the CPU: two gloo ranks, each building nothing but
what rank 0 broadcasts; the query-parallel batch equals ``execute_serial``
and the index-parallel one the query-parallel one."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_sharded_example_runs_under_torchrun_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                      os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         str(ROOT / "examples" / "torch_serve_skr_sharded.py"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "over 2 rank(s), backend gloo" in out.stdout
    assert "exact=True" in out.stdout
    assert "same ids and counters=True" in out.stdout
