"""Architecture registry: import every ported config module to register it."""
from repro_torch.configs import gemma3_1b, stablelm_1_6b  # noqa: F401
