"""The AWR encode, decode and loss: plain PyTorch versions, CUDA kernel
wrappers, dispatch."""
