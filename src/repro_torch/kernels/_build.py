"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``: seconds per file, where a build that
includes PyTorch's headers takes minutes. All sources build at once, one
``nvcc`` process each, the first time any kernel is launched (or when
``build_all`` is called). The libraries go to ``kernels/_build/`` inside
the checkout (listed in ``.gitignore``), named by a hash of the source and
the flags (and the shared ``*.cuh`` headers), so an edited source never
loads a stale library.

Nothing here runs at import time: this module imports on machines with no
CUDA toolkit, where only the plain PyTorch versions run.

Every kernel is a ``CudaKernel`` whose ``launches`` counter goes up by one
at each successful launch, and nowhere else.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{tag}.so"


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}  # source -> nvcc's stderr (ptxas register report)


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel (one nvcc per source) and
    load them all. Raises with nvcc's output when a build fails."""
    sources = sorted({k.source for k in KERNELS.values()})
    with _LOCK:
        todo = [s for s in sources if s not in _LIBS]
        pending = []
        for s in todo:
            out = _lib_path(s)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
            pending.append((s, out, tmp, proc))
        failed = []
        for s, out, tmp, proc in pending:
            stdout, stderr = proc.communicate()
            BUILD_LOG[s] = stdout + stderr
            if proc.returncode != 0:
                failed.append(f"{s}:\n{stdout}{stderr}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for s in todo:
            _LIBS[s] = ctypes.CDLL(str(_lib_path(s)))
        return {s: _LIBS[s] for s in sources}


@dataclasses.dataclass
class CudaKernel:
    """One C entry point of a ``csrc`` library, with its launch counter."""

    name: str
    source: str
    symbol: str
    argtypes: Tuple
    launches: int = 0
    _fn: object = dataclasses.field(default=None, repr=False)

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = build_all()[self.source]
            fn = getattr(lib, self.symbol)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            err_fn = lib.wisk_error_string
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            self._fn = (fn, err_fn)
        fn, err_fn = self._fn
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: error {err} "
                f"({err_fn(err).decode()})"
            )
        self.launches += 1


_FUSED_ARGS = (_P,) * 12 + (_I,) * 5
_REMAP_ARGS = (_P,) * 14 + (_I,) * 6
_WIDE_FUSED_ARGS = (_P,) * 10 + (_I,) * 5
_SLOTS_ARGS = (_P,) * 11 + (_I,) * 6 + (_P,)
_SLOTS_COMPACT_ARGS = (_P,) * 13 + (_I,) * 6 + (_P,)

KERNELS: Dict[str, CudaKernel] = {
    k.name: k
    for k in (
        CudaKernel(
            "frontier_level_narrow", "frontier.cu", "wisk_frontier_level_narrow",
            (_P,) * 8 + (_I,) * 7 + (_P,),
        ),
        CudaKernel(
            "frontier_level", "frontier.cu", "wisk_frontier_level",
            (_P,) * 6 + (_I,) * 5 + (_P,),
        ),
        CudaKernel(
            "knn_level_dist_narrow", "knn_filter.cu", "wisk_knn_level_dist_narrow",
            (_P,) * 9 + (_I,) * 8 + (_P,),
        ),
        CudaKernel(
            "knn_level_dist", "knn_filter.cu", "wisk_knn_level_dist",
            (_P,) * 7 + (_I,) * 6 + (_P,),
        ),
        # rows 2 and 3: the remapping instances (the engine's) and the
        # given-words ones, each counted apart
        CudaKernel(
            "fused_verify_remap_tile", "fused_verify_compact.cu",
            "wisk_fused_verify_remap_tile", _REMAP_ARGS + (_I, _I, _I, _P),
        ),
        CudaKernel(
            "fused_verify_remap_slot", "fused_verify_compact.cu",
            "wisk_fused_verify_remap_slot", _REMAP_ARGS + (_I, _P),
        ),
        CudaKernel(
            "fused_verify_compact_tile", "fused_verify_compact.cu",
            "wisk_fused_verify_compact_tile", _FUSED_ARGS + (_I, _I, _P),
        ),
        CudaKernel(
            "fused_verify_compact_slot", "fused_verify_compact.cu",
            "wisk_fused_verify_compact_slot", _FUSED_ARGS + (_I, _P),
        ),
        CudaKernel(
            "fused_verify_tile", "fused_verify.cu", "wisk_fused_verify_tile",
            (_P,) * 11 + (_I,) * 9 + (_P,),
        ),
        CudaKernel(
            "fused_verify_slot", "fused_verify.cu", "wisk_fused_verify_slot",
            _WIDE_FUSED_ARGS + (_I, _P),
        ),
        # the insert-slot entries and the gathered entries launch the same
        # two kernels, each counted apart
        CudaKernel(
            "skr_verify_slots_compact", "skr_verify.cu", "wisk_skr_verify_slots_compact",
            _SLOTS_COMPACT_ARGS,
        ),
        CudaKernel("skr_verify_slots", "skr_verify.cu", "wisk_skr_verify_slots", _SLOTS_ARGS),
        CudaKernel(
            "skr_verify_compact", "skr_verify.cu", "wisk_skr_verify_slots_compact",
            _SLOTS_COMPACT_ARGS,
        ),
        CudaKernel("skr_verify", "skr_verify.cu", "wisk_skr_verify_slots", _SLOTS_ARGS),
        CudaKernel(
            "skr_filter", "skr_filter.cu", "wisk_skr_filter",
            (_P,) * 5 + (_I,) * 5 + (_P,),
        ),
        # row 11: the matrix instance and the stream's pairs instance, each
        # counted apart
        CudaKernel(
            "sub_match", "sub_match.cu", "wisk_sub_match",
            (_P,) * 8 + (_I,) * 6 + (_P,),
        ),
        CudaKernel(
            "sub_match_pairs", "sub_match.cu", "wisk_sub_match_pairs",
            (_P,) * 7 + (_I,) * 6 + (_P,),
        ),
        CudaKernel(
            "cdf_mlp_bank", "cdf_mlp.cu", "wisk_cdf_mlp",
            (_P,) * 10 + (_I,) * 4 + (_P,),
        ),
    )
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
