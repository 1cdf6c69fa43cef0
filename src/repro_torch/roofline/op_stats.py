"""An op census of one traced step: the port's counterpart of the JAX
package's ``roofline/hlo_stats.py``.

The reference parses XLA's optimized HLO and re-counts while bodies by their
trip counts, because ``cost_analysis`` counts a loop body once. The port
has no HLO and no such undercount: eager PyTorch runs every op of every
layer, so a ``TorchDispatchMode`` over the step sees each one. ``OpStats``
counts, per rank:

* ``flops`` -- matrix-product flops as ``torch.utils.flop_counter``'s
  ``FlopCounterMode`` counts them (2·m·n·k a product; attention and
  convolutions by their formulas), by op in ``flops_by_op``;
* ``bytes`` -- what every aten op reads and writes: each tensor argument's
  bytes read and each result's written, views excepted (a view moves
  nothing). This is eager PyTorch's device-memory traffic before any
  fusion, an upper bound on what a fused step moves;
* ``calls`` -- aten calls (views included), each a launch or a host step;
* ``peak_live_bytes`` -- the most bytes of tensors the step had allocated
  and not yet freed at once: each op result that is not a view or an
  in-place update allocates its storage, and the storage's finaliser
  frees it. The step's arguments (weights, batch, cache) are not in it.

It runs on any device; on ``meta`` tensors nothing is allocated or
computed, which is how the dry run traces a full-size step on the host.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Census(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.calls = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.calls += 1
        aliased = any(r.alias_info is not None for r in func._schema.returns)
        if aliased and func.is_view:
            return out
        outs = _tensors(out)
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in outs)
        if not aliased:  # a fresh allocation per result
            for t in outs:
                s = t.untyped_storage()
                n = s.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(s, self._free, n)
        return out


class OpStats:
    """A context manager over one traced step; after it, ``as_dict()``."""

    def __init__(self) -> None:
        self._flops = FlopCounterMode(display=False)
        self._census = _Census()

    def __enter__(self) -> "OpStats":
        self._flops.__enter__()
        self._census.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._census.__exit__(*exc)
        self._flops.__exit__(*exc)

    @property
    def flops(self) -> int:
        return int(self._flops.get_total_flops())

    @property
    def bytes(self) -> int:
        return int(self._census.bytes)

    @property
    def calls(self) -> int:
        return int(self._census.calls)

    @property
    def peak_live_bytes(self) -> int:
        return int(self._census.peak)

    def flops_by_op(self) -> Dict[str, int]:
        counts = self._flops.get_flop_counts().get("Global", {})
        return {str(op): int(n) for op, n in counts.items()}

    def as_dict(self) -> Dict[str, object]:
        return dict(flops=self.flops, bytes=self.bytes, calls=self.calls,
                    peak_live_bytes=self.peak_live_bytes, flops_by_op=self.flops_by_op())
