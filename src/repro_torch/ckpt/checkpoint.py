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
    and, with ``shardings``, cuts this rank's block of it for a new mesh
    (the reference's re-shard on load);
  * garbage collection of old steps (``keep_n``).

Over a mesh of ranks a checkpoint still holds whole leaves, so one written
on four ranks restores on one device, on two or on four. An
``AsyncCheckpointer`` given the state's ``shardings``
(``Steps.state_shardings``; the mesh is theirs) gathers in ``submit`` each
leaf that is a rank's block, one leaf at a time, on the caller's thread and
in the same order on every rank (the gathers are collectives); only rank 0
keeps the whole leaves and only its writer thread writes.
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

from ..models.convert import to_block
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


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None, shardings: Any = None):
    """``(state, step)``: the checkpoint at ``step`` (default the latest)
    in ``template``'s structure, each leaf cast to its template leaf's
    dtype on its device. With ``shardings`` (a tree of ``sharding/rules.py``
    ``Sharding``s mirroring the template, for the mesh restored onto: the
    reference's ``NamedSharding``s) each leaf is this rank's block
    (``Sharding.index``). A model in the template is loaded in place."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step}"
    meta = json.loads((d / "manifest.json").read_text())
    t_leaves = leaves(template)
    if len(t_leaves) != meta["n_leaves"]:
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, template {len(t_leaves)}")
    sh_leaves = [None] * len(t_leaves) if shardings is None else leaves(shardings)
    if len(sh_leaves) != len(t_leaves):
        raise ValueError(f"{len(sh_leaves)} shardings for {len(t_leaves)} leaves")
    out = []
    for i, (tl, sh) in enumerate(zip(t_leaves, sh_leaves)):
        with np.load(d / f"leaf_{i}.npz") as z:
            arr = z["a"]
        if isinstance(tl, torch.Tensor):
            block = to_block(arr, sh)
            if tuple(block.shape) != tuple(tl.shape):
                raise ValueError(f"leaf {i}: the block {tuple(block.shape)} of {arr.shape} is "
                                 f"not the template's {tuple(tl.shape)}")
            out.append(block.to(tl.device, tl.dtype))
        else:
            out.append(arr)
    return unflatten(template, out), step


def _whole_leaf(x: torch.Tensor, sh):
    """The whole leaf of which ``x`` is this rank's block by ``sh``, on
    the host of rank 0 (None on the others); every rank holding a block
    calls it (an all-gather over the axes ``sh`` splits)."""
    mesh = sh.mesh
    axis = mesh.over(sh.axes)
    with torch.no_grad():
        got = axis.all_gather(x.detach().contiguous())
    if mesh.rank != 0:
        return None
    got = got.cpu()
    mine = {n: mesh.axis(n).index for n in mesh.axis_names}
    whole = torch.empty(sh.global_shape(x.shape), dtype=x.dtype)
    for j in range(axis.size):  # the gather's order: row major over sh.axes
        coords, rest = dict(mine), j
        for n in reversed(sh.axes):
            coords[n] = rest % mesh.axis(n).size
            rest //= mesh.axis(n).size
        whole[sh.index(whole.shape, coords)] = got[j]
    return whole


def _describe(tree: Any) -> str:
    """The structure, for the manifest's reader (restore reads the template)."""
    return str(tree_map(lambda x: tuple(getattr(x, "shape", ())), tree))


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return np.asarray(x)


class AsyncCheckpointer:
    """Background writer thread; ``wait()`` drains pending saves. With
    ``shardings`` (a tree of ``Sharding``s mirroring the states that
    ``submit`` takes) the state lives on their mesh: only its rank 0 writes
    (see the module), and every rank calls ``submit`` and ``close``."""

    def __init__(self, ckpt_dir: str, keep_n: int = 3, shardings: Any = None):
        self.ckpt_dir = ckpt_dir
        self.keep_n = keep_n
        self.shardings = None if shardings is None else leaves(shardings)
        meshes = {id(s.mesh): s.mesh for s in self.shardings or () if s is not None}
        if len(meshes) > 1:
            raise ValueError("the shardings lie on more than one mesh")
        self.mesh = next(iter(meshes.values()), None)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._t = None
        if self.mesh is None or self.mesh.rank == 0:
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
        the pending save. Over a mesh each leaf that is a rank's block is
        gathered whole to rank 0 first, a leaf at a time, and only rank 0
        queues the save."""
        if self._err:
            raise self._err
        if self.shardings is None:
            host = tree_map(_to_host, state)
        else:
            flat = leaves(state)
            if len(self.shardings) != len(flat):
                raise ValueError(f"{len(self.shardings)} shardings for {len(flat)} leaves")
            out = []
            for x, s in zip(flat, self.shardings):
                if isinstance(x, torch.Tensor) and s is not None and s.split:
                    out.append(_whole_leaf(x, s))
                else:  # only the writing rank keeps a copy
                    out.append(_to_host(x) if self._t is not None else None)
            if self._t is None:
                return
            host = unflatten(_plain(state), out)
        self._q.put((step, host))

    def wait(self):
        if self._t is not None:
            self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        if self._t is not None:
            self._q.put(None)
            self._t.join(timeout=10)
        if self.mesh is not None:  # the others wait for rank 0's last write
            self.mesh.broadcast_object(None)


def _plain(tree: Any) -> Any:
    """``tree`` with any model in it as its parameter dict (so that the
    host copy does not load into the live model)."""
    return tree_map(lambda x: x, tree)
