"""whisper-medium [audio] — enc-dec 24L(+24 enc) d=1024 16H (kv=16) ff=4096
V=51865; conv/mel frontend STUBBED (input_specs feeds 1500 frame embeddings).
[arXiv:2212.04356]"""
from repro_torch.common.config import ModelConfig, register_config


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio", num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=51865,
        mlp="gelu", norm="layernorm", is_encoder_decoder=True,
        encoder_layers=24, encoder_seq=1500, frontend="audio",
        tie_embeddings=True, source="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return full().replace(num_layers=2, encoder_layers=2, encoder_seq=16,
                          d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
                          vocab_size=512)


register_config("whisper-medium", full, smoke)
