#!/usr/bin/env python3
"""The JAX package's own decode drift from its prefill, on the CPU: what
the port's phase 19 and phase 20 checks are held against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_seq_drift.py [xlstm|hybrid]

``xlstm`` (the default): ``xlstm-125m`` of the JAX package at its
published widths, all 12 layers, in bf16 and in f32 (weights from
``init_state`` at ``PRNGKey(0)``; tokens of seed 1; B = 2, S = 256): the
last teacher-forced ``decode_step``'s logits against ``prefill_step``'s,
max |difference| over max |logit|, with the decode started at
``init_mlstm_state`` / ``init_slstm_state``'s stabilizers (``-1e30``) and
from ``cache_spec``'s zeros.

``hybrid``: ``jamba-v0.1-52b``'s ``reduced()`` config (two superblocks of
four layers, d_model 128), the same measure at B = 8, S = 256 (the
phase's check shape) from the zero cache (the Mamba mixer's own start),
in bf16 and in f32, with the MoE capacity as built (prefill drops the
choices past it, decode keeps them) and with ``capacity_factor=100`` (no
capacity binds). The reference's decode reads k and v through its bf16
cache in both dtypes.

It runs only the JAX package (a minute or two on a few CPU cores); the
port does not import it.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro.configs import get_config  # noqa: E402
from repro.train.step import build_steps  # noqa: E402

B, S = 2, 256
HYBRID_B, HYBRID_S = 8, 256


def drift(cfg, B: int, S: int, starts) -> str:
    """The last of S teacher-forced decode steps against prefill from each
    of ``starts`` (label, the zero cache -> the start), max |difference|
    over max |logit|."""
    steps = build_steps(cfg)
    params = jax.jit(steps.init_state)(jax.random.PRNGKey(0))["params"]
    toks = jnp.asarray(np.random.default_rng(1).integers(0, cfg.vocab, (B, S)), jnp.int32)
    want = np.asarray(jax.jit(steps.prefill_step)(params, dict(tokens=toks)), np.float32)
    dec = jax.jit(steps.decode_step)
    zero = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), steps.cache_spec(B, S)[0])
    out = []
    for label, start in starts:
        cache = start(zero)
        for i in range(S):
            got, cache = dec(params, cache, toks[:, i:i + 1], jnp.int32(i))
        got = np.asarray(got, np.float32)
        out.append(f"{label} {np.max(np.abs(got - want)) / np.max(np.abs(want)):.6f}")
    return ", ".join(out)


def hybrid() -> int:
    base = get_config("jamba-v0.1-52b").reduced()
    for dtype in ("bfloat16", "float32"):
        for cf in (base.capacity_factor, 100.0):
            cfg = dataclasses.replace(base, dtype=dtype, capacity_factor=cf)
            t = time.perf_counter()
            line = drift(cfg, HYBRID_B, HYBRID_S, [("zero cache", lambda z: z)])
            print(f"reference jamba-v0.1-52b reduced() n_layers={cfg.n_layers} d_model="
                  f"{cfg.d_model} {dtype} capacity_factor={cf} B={HYBRID_B} S={HYBRID_S}: "
                  f"{line} ({time.perf_counter() - t:.1f} s, JAX on the CPU)", flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["hybrid"]:
        return hybrid()
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config("xlstm-125m"), dtype=dtype)
        t = time.perf_counter()
        line = drift(cfg, B, S, [
            ("init_*_state", lambda z: dict(z, m=jnp.full_like(z["m"], -1e30),
                                            sm=jnp.full_like(z["sm"], -1e30))),
            ("zero cache", lambda z: z)])
        print(f"reference xlstm-125m n_layers={cfg.n_layers} {dtype} B={B} S={S}: {line} "
              f"({time.perf_counter() - t:.1f} s, JAX on the CPU)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
