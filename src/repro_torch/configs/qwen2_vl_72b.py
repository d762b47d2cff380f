"""qwen2-vl-72b [vlm] — 80L d=8192 64H (GQA kv=8) ff=29568 V=152064; M-RoPE
(sections 16/24/24 of head_dim/2=64); the ViT front end is stubbed (the model
takes patch embeddings). [arXiv:2409.12191]"""
from repro_torch.common.config import ModelConfig, register_config


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=8, d_ff=29568, vocab_size=152064,
        mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
        mlp="swiglu", tie_embeddings=False, frontend="vision",
        source="arXiv:2409.12191",
    )


def smoke() -> ModelConfig:
    return full().replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                          d_ff=256, vocab_size=512, mrope_sections=(8, 4, 4))


register_config("qwen2-vl-72b", full, smoke)
