"""modegpt_tpu_torch: the PyTorch/CUDA port of modegpt_tpu.

Training-free MoDeGPT compression (modular decomposition of the MLP, the
Q/K pair and the V/O pair) on an NVIDIA H100. The package mirrors
``modegpt_tpu``'s module layout and function names; it imports torch and
numpy only. The one hand-written kernel of the main path is causal flash
attention (``kernels/flash_attention.py``, CUDA source in ``csrc/``).

Entry points run on CUDA unless the caller passes ``device="cpu"``;
without CUDA, asking for it raises.
"""
