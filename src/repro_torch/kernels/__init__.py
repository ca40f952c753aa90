"""Hand-written Hopper kernels of the analytics and LM serving paths, each beside its plain
PyTorch version (see :mod:`repro_torch.kernels.build` for the build)."""
