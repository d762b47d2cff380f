"""Runnable twins of the reference's ``examples/`` scripts
(``python -m repro_torch.examples.<name>``)."""
