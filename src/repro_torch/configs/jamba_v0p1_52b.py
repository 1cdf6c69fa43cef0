"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
vocab=65536, MoE 16e top-2 (every other layer), Mamba+attn 1:7 interleave
(attention at layer i%8==3). Sub-quadratic outside 4 attn layers; runs
long_500k with attention KV sharded over ("data","model") on sequence.
[arXiv:2403.19887]"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, d_expert=14336, vocab=65536,
        n_experts=16, moe_topk=2, moe_every=2, attn_every=8,
        d_state=16, d_conv=4, expand=2, head_dim=128,
        optimizer="adafactor", subquadratic=True,
    )
