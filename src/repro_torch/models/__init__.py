"""The LM stack of the port: dense (GQA) and Mamba2 models for serving."""

from repro_torch.models.build import build_model
from repro_torch.models.convert import load_jax_params

__all__ = ["build_model", "load_jax_params"]
