"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304, sLSTM + mLSTM
blocks (1 sLSTM per 6 layers). Recurrent state -> sub-quadratic, runs
long_500k. [arXiv:2405.04517]"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m", family="xlstm", n_layers=12, d_model=768,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, slstm_every=6,
        expand=2, subquadratic=True, rope_theta=0.0,
        # 4 heads can't shard 16-way; TP runs on the 1536-wide inner dim.
        logical_overrides={"heads": None, "act_heads": None},
    )
