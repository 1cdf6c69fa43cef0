"""Run one cell of the WISK benchmark on the GPU and print its result line.

    python3 wiskbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; the program under test is the PyTorch and CUDA port in
``src/repro_torch``. The last line of standard output is the result as one
JSON object; the numbers the check compared, each beside its limit, are the
last lines of standard error. Exits with 2 and no result when the cell's
GPUs are not there, and with 3 when the process loaded the JAX package or
JAX.
"""
import time

_T0 = time.perf_counter()  # set-up starts here: imports, data, index, warm-up

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".wiskbench_cache"
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own nvcc builds go to src/repro_torch/kernels/_build)
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
# the package is found from the checkout's root, not from this file's folder
sys.path[:] = [str(ROOT / "src"), str(ROOT)] + sys.path[1:]


if __name__ == "__main__":
    from wiskbench import harness

    sys.exit(harness.main(sys.argv[1:], _T0))
