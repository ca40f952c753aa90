"""Hand-written Hopper kernels of the analytics path, each beside its plain
PyTorch version (see :mod:`repro_torch.kernels.build` for the build)."""
