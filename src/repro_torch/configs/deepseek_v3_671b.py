"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(routed expert)
vocab=129280, MoE 1 shared + 256 routed top-8, MLA, MTP. [arXiv:2412.19437; hf]

Dense d_ff (first 3 layers) is 18432 per the HF config; routed/shared expert
width (moe_intermediate_size) is 2048. MLA dims from the HF config.
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        family="mla_moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,          # dense layers' FFN width
        d_expert=2048,       # routed expert width (assignment's d_ff)
        vocab=129280,
        n_experts=256,
        moe_topk=8,
        n_shared_experts=1,
        first_dense=3,
        use_mla=True,
        q_lora=1536,
        kv_lora=512,
        qk_nope=128,
        qk_rope=64,
        v_head=128,
        head_dim=192,        # qk_nope + qk_rope
        mtp_depth=1,
        optimizer="adafactor",
        rope_theta=10000.0,
    )
