"""grad_roofline_pct: the binned kernel (``credits_kernel``,
``csrc/pagerank_credits.cu``) as logistic regression's gradient runs it, a
value an edge, against its roofline, as ``_kernel_roofline`` reads it
(pagerank's roofline gives the kernel no bound, so nothing there).  Not
``g_roofline_pct``, which reads the accumulator's kernel G."""

from stepbench.metrics._kernel_roofline import read_kernel


def read(obs):
    return read_kernel(obs, "credits_kernel")
