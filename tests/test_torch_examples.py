"""The port's single-process walkthroughs on the CPU, each as a
subprocess: ``examples/torch_quickstart.py`` and
``examples/torch_serve_skr_batched.py`` at a small ``--n`` (the port's CPU
build at the reference's 4,000 objects takes minutes: its partitioner and
packing run their plain versions), the batched example asserting that its
ids equal ``execute_serial`` over its own build; and
``examples/torch_train_lm.py`` at a few steps of a small model, then
resumed from its checkpoint."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args, timeout=180):
    # one intra-op thread: the builds' small ops would otherwise spin a full
    # thread team each, against the suite's parallel workers
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
                          *args], env=env, capture_output=True, text=True, timeout=timeout,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_quickstart_example_on_cpu():
    out = _run("torch_quickstart.py", "--n", "300")
    assert "dataset: 300 objects" in out
    assert "built WISK on cpu" in out and "results exact." in out


def test_serve_skr_batched_example_equals_execute_serial_on_cpu():
    out = _run("torch_serve_skr_batched.py", "--n", "300")
    assert "batched pipeline on cpu: 64 queries" in out and "exact=True" in out


def test_train_lm_example_trains_and_resumes_on_cpu(tmp_path):
    small = ["--d-model", "64", "--layers", "2", "--batch", "2", "--seq", "32",
             "--ckpt", str(tmp_path)]
    out = _run("torch_train_lm.py", "--steps", "3", *small)
    assert "done on cpu: 3 steps" in out and "restored_from=None" in out
    out = _run("torch_train_lm.py", "--steps", "5", *small)
    assert "done on cpu: 2 steps" in out and "restored_from=3" in out
