"""Published peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W power limit): the yardstick of every
roofline share and MFU the benchmark reports."""

HBM_BYTES_PER_S = 3.35e12
PEAK_F32 = 67e12  # FLOP/s outside the tensor cores
PEAK_TF32 = 495e12  # dense TF32 tensor-core FLOP/s
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s

# The peak a product of each stated precision runs at: float32 products run
# on the tensor cores (TF32 inputs, 3xTF32 for float32 accuracy), so their
# ceiling is the TF32 rate; counted once, a 3xTF32 product cannot pass it.
PEAK_BY_PRECISION = {"float32": PEAK_TF32, "bfloat16": PEAK_BF16}
