"""falcon-mamba-7b [ssm] — 64L d=4096 attention-free Mamba-1, V=65024,
ssm_state=16. [arXiv:2410.05355]"""
from repro_torch.common.config import ModelConfig, register_config


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm", num_layers=64, d_model=4096,
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=65024,
        attention="none", ssm_state=16, ssm_version=1, ssm_expand=2, ssm_conv=4,
        source="arXiv:2410.05355",
    )


def smoke() -> ModelConfig:
    return full().replace(num_layers=2, d_model=128, vocab_size=512, ssm_state=8)


register_config("falcon-mamba-7b", full, smoke)
