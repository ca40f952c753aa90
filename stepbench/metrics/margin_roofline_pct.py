"""margin_roofline_pct: logistic regression's margin kernel
(``margin_kernel``, ``csrc/logreg_margin.cu``: each row's margin and
residual) against its roofline, as ``_kernel_roofline`` reads it."""

from stepbench.metrics._kernel_roofline import read_kernel


def read(obs):
    return read_kernel(obs, "margin_kernel")
