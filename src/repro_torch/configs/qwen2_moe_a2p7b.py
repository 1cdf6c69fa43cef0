"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H d_ff=1408(expert) vocab=151936,
MoE 4 shared + 60 routed top-4. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5632,        # shared-expert aggregate width (4 x 1408)
        d_expert=1408,
        vocab=151936,
        n_experts=60,
        moe_topk=4,
        n_shared_experts=4,
    )
