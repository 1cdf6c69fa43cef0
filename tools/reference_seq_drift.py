#!/usr/bin/env python3
"""The JAX package's own xLSTM decode drift from its prefill, on the CPU:
what the port's phase 19 check is held against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_seq_drift.py

``xlstm-125m`` of the JAX package at its published widths, all 12 layers,
in bf16 and in f32 (weights from ``init_state`` at ``PRNGKey(0)``; tokens
of seed 1; B = 2, S = 256): the last teacher-forced ``decode_step``'s
logits against ``prefill_step``'s, max |difference| over max |logit|,
with the decode started at ``init_mlstm_state`` / ``init_slstm_state``'s
stabilizers (``-1e30``) and from ``cache_spec``'s zeros. It runs only the
JAX package (about a minute on a few CPU cores); the port does not
import it.
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


def main() -> int:
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config("xlstm-125m"), dtype=dtype)
        steps = build_steps(cfg)
        params = jax.jit(steps.init_state)(jax.random.PRNGKey(0))["params"]
        toks = jnp.asarray(np.random.default_rng(1).integers(0, cfg.vocab, (B, S)), jnp.int32)
        t = time.perf_counter()
        want = np.asarray(jax.jit(steps.prefill_step)(params, dict(tokens=toks)), np.float32)
        dec = jax.jit(steps.decode_step)
        zero = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), steps.cache_spec(B, S)[0])
        out = []
        for label, cache in (("init_*_state", dict(zero, m=jnp.full_like(zero["m"], -1e30),
                                                   sm=jnp.full_like(zero["sm"], -1e30))),
                             ("zero cache", zero)):
            for i in range(S):
                got, cache = dec(params, cache, toks[:, i:i + 1], jnp.int32(i))
            got = np.asarray(got, np.float32)
            out.append(f"{label} {np.max(np.abs(got - want)) / np.max(np.abs(want)):.6f}")
        print(f"reference xlstm-125m n_layers={cfg.n_layers} {dtype} B={B} S={S}: "
              + ", ".join(out) + f" ({time.perf_counter() - t:.1f} s, JAX on the CPU)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
