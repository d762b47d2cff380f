"""gemma3-4b [dense] — 34L d=2560 8H (GQA kv=4) ff=10240 V=262144;
5:1 local:global, 128k. [hf:google/gemma-3-1b-pt]"""
from repro_torch.common.config import ModelConfig, register_config


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense", num_layers=34, d_model=2560,
        num_heads=8, num_kv_heads=4, head_dim=256, d_ff=10240, vocab_size=262144,
        sliding_window=1024, local_global_ratio=5, qk_norm=True,
        rope_theta=1_000_000.0, mlp="geglu", max_seq_len=131072,
        # the reference's field as it stands: it names the 1b card
        source="hf:google/gemma-3-1b-pt",
    )


def smoke() -> ModelConfig:
    return full().replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                          head_dim=32, d_ff=256, vocab_size=512, sliding_window=32)


register_config("gemma3-4b", full, smoke)
