from repro_torch.optim.optimizers import halving_schedule  # noqa: F401
