"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H d_ff=8192 vocab=32064;
phi3-mini backbone + CLIP frontend (stub: precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32064,
        n_patches=576,   # CLIP ViT-L/14 @ 336px
    )
