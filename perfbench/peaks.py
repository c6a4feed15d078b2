"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).

Every roofline and utilisation share of the benchmark is taken against
these, whatever route an implementation takes: a float32 product is held
to the TF32 tensor-core rate, the card's highest rate for float32 inputs,
so no float32 implementation can read above 100%.
"""

TF32_FLOPS = 494.7e12  # dense TF32 tensor-core FLOP/s: the peak for float32 work
BF16_FLOPS = 989.0e12
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
