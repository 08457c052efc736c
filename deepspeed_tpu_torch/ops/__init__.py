"""Kernels of the port: each hand-written CUDA kernel (``csrc/``) with its
Python wrapper and its plain PyTorch version, one module per kernel
(:mod:`.flash_attention`, :mod:`.paged_attention`,
:mod:`.grouped_matmul`, :mod:`.quantized_linear`, :mod:`.quantizer`).
:mod:`.op_builder` builds them with nvcc and counts their launches."""
