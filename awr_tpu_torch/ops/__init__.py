"""The AWR encode, decode and loss, and the int8 GEMM and deconv: plain
PyTorch versions, CUDA kernel wrappers, dispatch."""
