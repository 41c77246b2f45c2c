"""Hand-written CUDA kernels for the availability scan, their launch
wrappers, and their plain PyTorch versions (``ref``)."""
