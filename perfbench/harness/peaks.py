"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit)."""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12  # dense TF32: cuDNN runs fp32 convolutions on it by default
