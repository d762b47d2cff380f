"""Architecture registry: import every config module to register it."""
from repro_torch.configs import (deepseek_v3_671b, falcon_mamba_7b, gemma3_1b,  # noqa: F401
                                 gemma3_4b, grok_1_314b, nemotron_4_15b, paper_models,
                                 qwen2_vl_72b, stablelm_1_6b, whisper_medium, zamba2_2_7b)
