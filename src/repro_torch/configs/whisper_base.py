"""whisper-base [audio]: enc-dec, 6L encoder + 6L decoder, d_model=512 8H
d_ff=2048 vocab=51865, conv frontend STUB (precomputed frame embeddings).
[arXiv:2212.04356]"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base",
        family="encdec",
        n_layers=6,       # decoder layers
        enc_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=51865,
        enc_frames_div=4,
        rope_theta=0.0,   # whisper uses learned/sinusoidal abs positions
        # 8 heads and an odd vocab (51865) cannot shard 16-way: replicate
        # those dims; TP still applies to the 2048-wide FFN (DESIGN.md).
        logical_overrides={"heads": None, "act_heads": None, "kv_heads": None,
                           "vocab": None, "act_vocab": None},
    )
