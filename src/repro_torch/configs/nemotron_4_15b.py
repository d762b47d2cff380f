"""nemotron-4-15b [dense] — 32L d=6144 48H (GQA kv=8) ff=24576 V=256000;
squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.common.config import ModelConfig, register_config


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense", num_layers=32, d_model=6144,
        num_heads=48, num_kv_heads=8, d_ff=24576, vocab_size=256000,
        mlp="squared_relu", norm="layernorm", rope_theta=10000.0,
        tie_embeddings=False, source="arXiv:2402.16819",
    )


def smoke() -> ModelConfig:
    return full().replace(num_layers=2, d_model=192, num_heads=6, num_kv_heads=2,
                          d_ff=384, vocab_size=512)


register_config("nemotron-4-15b", full, smoke)
