"""grok-1-314b [moe] — 64L d=6144 48H (GQA kv=8) ff=32768, 8 experts top-2,
V=131072. [hf:xai-org/grok-1]"""
from repro_torch.common.config import ModelConfig, register_config


def full() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe", num_layers=64, d_model=6144,
        num_heads=48, num_kv_heads=8, d_ff=32768, vocab_size=131072,
        num_experts=8, experts_per_token=2, moe_d_ff=32768,
        mlp="geglu", tie_embeddings=False, source="hf:xai-org/grok-1",
    )


def smoke() -> ModelConfig:
    return full().replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                          d_ff=256, vocab_size=512, num_experts=4,
                          experts_per_token=2, moe_d_ff=256)


register_config("grok-1-314b", full, smoke)
