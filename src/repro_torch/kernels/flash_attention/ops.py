"""Model-layout entry point of the flash attention kernel.

Port of :mod:`repro.kernels.flash_attention.ops`: q (B, T, KH, G, d), k and
v (B, S, KH, d) → (B, T, KH, G, dv).  The CUDA kernel takes this layout as it
is, so the entry point is the kernel's wrapper itself
(:func:`~repro_torch.kernels.flash_attention.kernel.flash_attention_gqa`);
the JAX wrapper's transposes and broadcast of K/V over G remain only in the
plain version a CPU tensor runs.
"""

from repro_torch.kernels.flash_attention.kernel import flash_attention_gqa as flash_attention

__all__ = ["flash_attention"]
