"""PyTorch / CUDA port of ``awr_tpu`` for NVIDIA Hopper GPUs.

Imports torch and numpy only.  Entry points run on CUDA unless the
caller names another device; on a CUDA tensor the AWR encode, decode and
decode backward are the hand-written kernels in ``csrc/encode.cu`` and
``csrc/decode.cu``.
"""
