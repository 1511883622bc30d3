"""PyTorch / CUDA port of ``awr_tpu`` for NVIDIA Hopper GPUs.

Imports torch and numpy only.  Entry points run on CUDA unless the
caller names another device; on a CUDA tensor the AWR encode, decode and
decode backward, and the int8 GEMM and deconv of quantized serving, are
the hand-written kernels in ``csrc/encode.cu``, ``csrc/decode.cu`` and
``csrc/int8.cu``.
"""
