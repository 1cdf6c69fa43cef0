"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, RoPE. [arXiv:2402.19173]"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
        n_heads=36, n_kv_heads=4, d_ff=18432, vocab=49152, head_dim=128,
        # 36 heads don't divide the 16-way model axis: zero-pad to 48
        # (exactly function-preserving; padding stays zero under SGD).
        pad_heads_to=48,
    )
