"""deepseek-v3-671b [moe] — 61L d=7168 128H MLA, 1 shared + 256 routed top-8
experts (moe ff=2048), V=129280, first 3 layers dense. [arXiv:2412.19437]

MLA dims per the paper: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64,
v_head 128. MTP (multi-token prediction) is not modelled; the serving
engine's self-speculative draft takes its place.
"""
from repro_torch.common.config import ModelConfig, register_config


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", num_layers=61, d_model=7168,
        num_heads=128, num_kv_heads=128, head_dim=128, d_ff=18432,
        vocab_size=129280, attention="mla",
        q_lora_rank=1536, kv_lora_rank=512, qk_rope_head_dim=64, v_head_dim=128,
        num_experts=256, num_shared_experts=1, experts_per_token=8,
        moe_d_ff=2048, first_dense_layers=3, mlp="swiglu",
        tie_embeddings=False, source="arXiv:2412.19437",
    )


def smoke() -> ModelConfig:
    return full().replace(num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
                          head_dim=32, q_lora_rank=32, kv_lora_rank=32,
                          qk_rope_head_dim=16, v_head_dim=32, d_ff=256,
                          vocab_size=512, num_experts=4, experts_per_token=2,
                          moe_d_ff=64, first_dense_layers=1)


register_config("deepseek-v3-671b", full, smoke)
