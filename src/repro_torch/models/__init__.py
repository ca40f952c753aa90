"""The LM stack of the port: dense (GQA) and Mamba2 models for serving and
training."""

from repro_torch.models.build import Model, build_model
from repro_torch.models.common import apply_rope, layer_norm, rms_norm, softmax_cross_entropy
from repro_torch.models.convert import load_jax_opt_state, load_jax_params

__all__ = ["Model", "apply_rope", "build_model", "layer_norm", "load_jax_opt_state",
           "load_jax_params", "rms_norm", "softmax_cross_entropy"]
