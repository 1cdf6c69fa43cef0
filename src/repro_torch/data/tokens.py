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
        another): int32 ``tokens`` (batch, seq); for ``encdec`` also f32
        ``frames`` (batch, max(seq // enc_frames_div, 8), d_model), for
        ``vlm`` f32 ``patches`` (batch, min(n_patches, max(seq // 4, 4)),
        d_model), each drawn from a seed of its own after the step is
        advanced, as the reference."""
        dev = resolve_device(device)
        toks = self._batch_tokens(self.step)
        self.step += 1
        tokens = torch.from_numpy(toks).to(dev)
        if cfg.family == "encdec":
            rng = np.random.default_rng(np.uint64(self.seed * 7_000_003 + self.step))
            frames = rng.normal(0, 1, size=(self.batch, max(self.seq // cfg.enc_frames_div, 8),
                                            cfg.d_model))
            return dict(frames=torch.from_numpy(frames.astype(np.float32)).to(dev), tokens=tokens)
        if cfg.family == "vlm":
            P = min(cfg.n_patches, max(self.seq // 4, 4))
            rng = np.random.default_rng(np.uint64(self.seed * 9_000_003 + self.step))
            patches = rng.normal(0, 1, size=(self.batch, P, cfg.d_model))
            return dict(patches=torch.from_numpy(patches.astype(np.float32)).to(dev),
                        tokens=tokens)
        return dict(tokens=tokens)
