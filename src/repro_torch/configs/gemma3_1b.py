"""gemma3-1b [dense] — 26L d=1152 4H (GQA kv=1) ff=6912 V=262144;
5:1 local:global attention, 128k context. [hf:google/gemma-3-1b-pt]"""
from repro_torch.common.config import ModelConfig, register_config


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense", num_layers=26, d_model=1152,
        num_heads=4, num_kv_heads=1, head_dim=256, d_ff=6912, vocab_size=262144,
        sliding_window=1024, local_global_ratio=5, qk_norm=True,
        rope_theta=1_000_000.0, mlp="geglu", max_seq_len=131072,
        source="hf:google/gemma-3-1b-pt",
    )


def smoke() -> ModelConfig:
    return full().replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
                          head_dim=32, d_ff=256, vocab_size=512, sliding_window=32)


register_config("gemma3-1b", full, smoke)
