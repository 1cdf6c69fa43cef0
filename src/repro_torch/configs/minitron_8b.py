"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000, pruned nemotron. [arXiv:2407.14679]"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="minitron-8b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=16384, vocab=256000, head_dim=128,
    )
