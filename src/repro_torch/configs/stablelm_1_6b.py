"""stablelm-1.6b [dense] — 24L d=2048 32H (GQA kv=32) ff=5632 V=100352.
[hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.common.config import ModelConfig, register_config


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense", num_layers=24, d_model=2048,
        num_heads=32, num_kv_heads=32, d_ff=5632, vocab_size=100352,
        mlp="swiglu", norm="layernorm", rope_theta=10000.0,
        source="hf:stabilityai/stablelm-2-1_6b",
    )


def smoke() -> ModelConfig:
    return full().replace(num_layers=2, d_model=128, num_heads=8, num_kv_heads=8,
                          d_ff=256, vocab_size=512)


register_config("stablelm-1.6b", full, smoke)
