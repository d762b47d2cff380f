"""Architecture registry: import every config module to register it."""
from repro_torch.configs import (deepseek_v3_671b, falcon_mamba_7b, gemma3_1b,  # noqa: F401
                                 gemma3_4b, grok_1_314b, nemotron_4_15b, paper_models,
                                 qwen2_vl_72b, stablelm_1_6b, whisper_medium, zamba2_2_7b)

ASSIGNED = [
    "gemma3-1b", "zamba2-2.7b", "falcon-mamba-7b", "whisper-medium",
    "stablelm-1.6b", "nemotron-4-15b", "deepseek-v3-671b", "grok-1-314b",
    "qwen2-vl-72b", "gemma3-4b",
]
