"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) — the yardstick of every roofline
share the benchmark reports."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# three TF32 products (3xTF32) give a float32-accurate product: the fastest
# float32-accurate matrix rate on the chip
FP32_ACCURATE_FLOPS = TF32_FLOPS / 3
