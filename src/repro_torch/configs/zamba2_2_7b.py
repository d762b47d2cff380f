"""zamba2-2.7b [hybrid] — 54L d=2560 Mamba2 blocks + shared attention block
(32H kv=32, ff=10240 in the shared block) V=32000, ssm_state=64.
[arXiv:2411.15242]"""
from repro_torch.common.config import ModelConfig, register_config


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
        num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
        ssm_state=64, ssm_version=2, ssm_headdim=64, ssm_expand=2,
        hybrid_attn_every=6, sliding_window=2048,
        source="arXiv:2411.15242",
    )


def smoke() -> ModelConfig:
    return full().replace(num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
                          d_ff=256, vocab_size=512, ssm_state=16, ssm_headdim=32,
                          hybrid_attn_every=2, sliding_window=32)


register_config("zamba2-2.7b", full, smoke)
