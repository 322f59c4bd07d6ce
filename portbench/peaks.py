"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W power limit)."""

FP32_FLOPS = 67e12        # float32 on the CUDA cores (no tensor cores)
FP64_FLOPS = 34e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
HBM_BYTES = 80e9
