"""Column physics in PyTorch and the CUDA day kernel's dispatch."""
