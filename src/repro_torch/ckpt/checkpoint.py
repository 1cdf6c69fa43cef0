"""Checkpoints of the training state: the JAX package's
``ckpt/checkpoint.py``, in its on-disk layout.

Layout: ``<dir>/step_<N>/manifest.json`` plus ``leaf_<i>.npz`` (array
``a``) for each leaf in the JAX package's flatten order (``tree.leaves``:
dict keys sorted, NamedTuple fields in order; a model stands for its
parameter dict). A bf16 leaf is stored widened to f32 with ``"dtype":
"bfloat16"`` in the manifest, as the reference stores it, so a checkpoint
written by either package restores in the other.

  * atomic publish: written to a temporary directory, then renamed, so a
    crash mid-save never corrupts the latest checkpoint;
  * ``AsyncCheckpointer``: a writer thread, training continues while the
    previous step saves; ``submit`` copies the state to the host first;
  * ``restore`` places each leaf on its template leaf's device and dtype
    (the one-device meaning of the reference's ``shardings``);
  * garbage collection of old steps (``keep_n``).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..tree import leaves, tree_map, unflatten

# what numpy stores as it is; any other dtype (bf16) is stored widened to f32
_NUMPY_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16", "int8", "uint8",
                 "uint16", "uint32", "uint64", "bool")


def _host_array(leaf) -> tuple:
    """``(numpy array, dtype name)`` of a leaf as the reference writes it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        dtype = str(t.dtype).removeprefix("torch.")
        arr = (t.float() if dtype not in _NUMPY_DTYPES else t).numpy()
    else:
        arr = np.asarray(leaf)
        dtype = str(arr.dtype)
    return arr, dtype


def save(ckpt_dir: str, step: int, state: Any, keep_n: int = 3) -> str:
    """Synchronous save with an atomic publish; the newest ``keep_n``
    steps stay."""
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f".tmp_step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat = leaves(state)
    meta = dict(step=step, n_leaves=len(flat), treedef=_describe(state), time=time.time())
    shapes = []
    for i, leaf in enumerate(flat):
        arr, dtype = _host_array(leaf)
        if dtype not in _NUMPY_DTYPES:
            arr = arr.astype(np.float32)  # bf16 etc.: stored widened, restore re-casts
        np.savez(tmp / f"leaf_{i}.npz", a=arr)
        shapes.append(dict(shape=list(arr.shape), dtype=dtype))
    meta["leaves"] = shapes
    (tmp / "manifest.json").write_text(json.dumps(meta))
    final = base / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    steps = sorted((int(p.name.split("_")[1]) for p in base.glob("step_*")), reverse=True)
    for s in steps[keep_n:]:
        shutil.rmtree(base / f"step_{s}", ignore_errors=True)
    return str(final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("step_*")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None):
    """``(state, step)``: the checkpoint at ``step`` (default the latest)
    in ``template``'s structure, each leaf cast to its template leaf's
    dtype on its device. A model in the template is loaded in place."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step}"
    meta = json.loads((d / "manifest.json").read_text())
    t_leaves = leaves(template)
    if len(t_leaves) != meta["n_leaves"]:
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, template {len(t_leaves)}")
    out = []
    for i, tl in enumerate(t_leaves):
        with np.load(d / f"leaf_{i}.npz") as z:
            arr = z["a"]
        if isinstance(tl, torch.Tensor):
            out.append(torch.from_numpy(np.array(arr)).to(tl.device, tl.dtype))
        else:
            out.append(arr)
    return unflatten(template, out), step


def _describe(tree: Any) -> str:
    """The structure, for the manifest's reader (restore reads the template)."""
    return str(tree_map(lambda x: tuple(getattr(x, "shape", ())), tree))


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return np.asarray(x)


class AsyncCheckpointer:
    """Background writer thread; ``wait()`` drains pending saves."""

    def __init__(self, ckpt_dir: str, keep_n: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_n = keep_n
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, state = item
            try:
                save(self.ckpt_dir, step, state, self.keep_n)
            except Exception as e:  # reported by the next submit or wait
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, state: Any):
        """Queue a save of ``state`` at ``step``. Every tensor is copied to
        the host before this returns, so later in-place steps cannot reach
        the pending save."""
        if self._err:
            raise self._err
        self._q.put((step, tree_map(_to_host, state)))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join(timeout=10)
