"""Architecture configuration system: the JAX package's ``configs/base.py``.

One ``ArchConfig`` per assigned architecture (``configs/<id>.py``), with the
exact published numbers, plus a ``reduced()`` shrink used by CPU tests.
Fields, defaults, ``__post_init__`` and ``reduced()`` are the reference's,
so a reduced model means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class ArchConfig:
    name: str
    family: str  # dense | moe | mla_moe | encdec | vlm | xlstm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    moe_topk: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0  # per-expert FFN width
    capacity_factor: float = 1.25
    moe_every: int = 1  # MoE FFN on layers where (i % moe_every) == moe_every-1
    first_dense: int = 0  # leading dense-FFN layers (deepseek-v3: 3)

    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    mtp_depth: int = 0

    # SSM / hybrid
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    attn_every: int = 0  # jamba: attention layer where (i % attn_every)==attn_every//2
    dt_rank: int = 0

    # xLSTM
    slstm_every: int = 0  # sLSTM on layers where (i % slstm_every)==slstm_every-1

    # enc-dec (whisper) / vlm (phi-3-v)
    enc_layers: int = 0
    enc_frames_div: int = 4  # S_enc = seq // enc_frames_div
    n_patches: int = 0

    rope_theta: float = 10000.0
    pad_heads_to: int = 0  # zero-pad attention heads to a TP multiple (exact)
    logical_overrides: Optional[Dict[str, object]] = None  # per-arch rule patches
    dtype: str = "bfloat16"
    optimizer: str = "adamw"
    remat: str = "full"  # full | none
    causal_impl: str = "masked_scan"  # masked_scan | unrolled_prefix
    attn_chunk: int = 1024
    ssm_chunk: int = 128
    scan_layers: bool = True
    subquadratic: bool = False  # can run long_500k
    has_decode: bool = True
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            self.head_dim = self.d_model // self.n_heads
        if self.dt_rank == 0:
            self.dt_rank = max(1, self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        r = dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.attn_every == 0 else 8),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            moe_topk=min(self.moe_topk, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            d_expert=64 if self.d_expert else 0,
            first_dense=min(self.first_dense, 1),
            q_lora=64 if self.q_lora else 0,
            kv_lora=32 if self.kv_lora else 0,
            qk_nope=32 if self.qk_nope else 0,
            qk_rope=16 if self.qk_rope else 0,
            v_head=32 if self.v_head else 0,
            enc_layers=min(self.enc_layers, 2),
            n_patches=min(self.n_patches, 16),
            d_state=min(self.d_state, 8),
            dt_rank=8,
            attn_chunk=64,
            ssm_chunk=32,
            dtype="float32",
            remat="none",
        )
        if self.attn_every:
            r = dataclasses.replace(r, attn_every=4, n_layers=8, moe_every=2)
        if self.slstm_every:
            r = dataclasses.replace(r, slstm_every=2, n_layers=4)
        return r


# (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig):
    """Which of the 4 assigned shapes apply to this arch (see DESIGN.md)."""
    out = ["train_4k", "prefill_32k"]
    if cfg.has_decode:
        out.append("decode_32k")
        if cfg.subquadratic:
            out.append("long_500k")
    return out
