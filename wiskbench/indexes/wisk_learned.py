"""The learned WISK index (paper §5-§6): ``build_wisk`` on the device over
a training workload made by the frozen query generator.

``params["train"]`` gives the training workload (``m``, ``dist``,
``region_frac``, ``n_keywords``, ``seed``); ``params["build"]`` overrides
fields of the port's ``BuildConfig`` (nested groups as nested objects; an
empty object is the paper's defaults).
"""
from __future__ import annotations

import dataclasses


def _replace(obj, over: dict):
    """``obj`` (a dataclass) with ``over``'s fields, nested groups too."""
    fields = {}
    for k, v in over.items():
        cur = getattr(obj, k)
        fields[k] = _replace(cur, v) if dataclasses.is_dataclass(cur) and isinstance(v, dict) else v
    return dataclasses.replace(obj, **fields)


def build(dataset, data, params, device):
    from repro_torch.core.build import BuildConfig, build_wisk
    from repro_torch.core.types import Workload

    from wiskbench.gen.workloads import make_workload

    t = params["train"]
    q = make_workload(data, m=int(t["m"]), dist=t["dist"], region_frac=float(t["region_frac"]),
                      n_keywords=int(t["n_keywords"]), seed=int(t["seed"]))
    train = Workload(q.rects, q.kw_ids, q.kw_bitmap, q.vocab_size)
    config = _replace(BuildConfig(), params.get("build", {}))
    return build_wisk(dataset, train, config, device=device).index
