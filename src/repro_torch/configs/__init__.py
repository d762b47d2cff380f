"""Architecture registry: import every ported config module to register it."""
from repro_torch.configs import (falcon_mamba_7b, gemma3_1b, gemma3_4b,  # noqa: F401
                                 nemotron_4_15b, paper_models, stablelm_1_6b, zamba2_2_7b)
