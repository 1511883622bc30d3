"""End-to-end runs of the port on the GPU."""
