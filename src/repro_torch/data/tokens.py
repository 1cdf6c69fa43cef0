"""Deterministic synthetic LM token pipeline: the JAX package's
``data/tokens.py``.

Markov-ish token streams from a fixed seed, drawn with numpy exactly as
the reference draws them, so both packages see the same tokens bit for
bit. The draws are counter-based (a batch depends only on the seed and
the step), so ``skip_to(step)`` fast-forwards a restart without
replaying. A real deployment swaps this for a file-backed loader with the
same interface.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import resolve_device


class TokenPipeline:
    def __init__(self, vocab: int, seq: int, batch: int, seed: int = 0):
        self.vocab = vocab
        self.seq = seq
        self.batch = batch
        self.seed = seed
        self.step = 0

    def skip_to(self, step: int):
        self.step = step

    def _batch_tokens(self, step: int) -> np.ndarray:
        # counter-based generation: content depends only on (seed, step)
        rng = np.random.default_rng(np.uint64(self.seed * 1_000_003 + step))
        # zipf-ish marginal + short-range repetition structure
        base = rng.zipf(1.3, size=(self.batch, self.seq)) % self.vocab
        rep = rng.integers(0, 4, size=(self.batch, self.seq)) == 0
        shifted = np.roll(base, 3, axis=1)
        return np.where(rep, shifted, base).astype(np.int32)

    def next_batch(self, cfg, device=None) -> Dict[str, torch.Tensor]:
        """The next batch on ``device`` (``cuda`` unless the caller names
        another): int32 ``tokens`` (batch, seq), and for ``vlm`` f32
        ``patches`` (batch, min(n_patches, max(seq // 4, 4)), d_model)."""
        if cfg.family == "encdec":
            raise NotImplementedError(
                "the encdec family's frames are not ported yet (ROADMAP A.13e)")
        dev = resolve_device(device)
        toks = self._batch_tokens(self.step)
        self.step += 1
        out = dict(tokens=torch.from_numpy(toks).to(dev))
        if cfg.family == "vlm":
            P = min(cfg.n_patches, max(self.seq // 4, 4))
            rng = np.random.default_rng(np.uint64(self.seed * 9_000_003 + self.step))
            patches = rng.normal(0, 1, size=(self.batch, P, cfg.d_model))
            out["patches"] = torch.from_numpy(patches.astype(np.float32)).to(dev)
        return out
