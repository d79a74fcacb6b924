"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the 700 W power limit).  The configurations compute in float32 with TF32
off, so float32 outside the tensor cores is the rate that bounds them."""

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
