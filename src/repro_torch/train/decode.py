"""Batched LM decoding loops driving ``Steps.decode_step``: the JAX
package's ``train/decode.py``."""
from __future__ import annotations

import torch


@torch.no_grad()
def greedy_generate(steps, params, cache, prompt_tokens: torch.Tensor, n_new: int,
                    start_pos: int):
    """Batched greedy decode from ``prompt_tokens[:, -1:]`` at ``start_pos``,
    as the reference: ``(tokens (B, n_new) int32, cache)``. The position
    stays a device tensor, so the loop makes no host sync per token."""
    tok = prompt_tokens[:, -1:].to(torch.int32)
    pos = torch.tensor(start_pos, dtype=torch.int32, device=tok.device)
    out = []
    for _ in range(n_new):
        logits, cache = steps.decode_step(params, cache, tok, pos)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    return torch.cat(out, dim=1), cache
