"""Hand-written CUDA attention kernels with their plain PyTorch
versions (``ref``) and the public entry points (``ops``)."""
