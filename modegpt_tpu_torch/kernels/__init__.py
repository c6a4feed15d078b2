"""Hand-written CUDA kernels (sources in ../csrc), their builder and their plain PyTorch versions."""
