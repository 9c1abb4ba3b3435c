"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the build module that compiles the sources under ``csrc/`` at first use."""
